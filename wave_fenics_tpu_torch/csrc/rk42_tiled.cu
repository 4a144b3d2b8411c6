// Kernel J's step boundary on Hopper (sm_90a), on the 2.5D tiled stencil of
// stencil_tiled.cuh with TMA plane loads.
//
// Kernel J replaces the TPU kernel
// wave_fenics_tpu/ops/pallas_rk42step.py::_kernel_rk42_step: two
// full-tableau RK4 steps in seven launches instead of kernel C's eight.
// Stages 0..2 of step 1 and stages 1..3 of step 2 are kernel C's stages
// (rk4_tiled.cu, lean = 0); the step boundary, step 1's stage 3 and step
// 2's stage 0, is one launch of rk42_boundary_tiled_kernel<T, P>, which at
// each interior point computes, with a = dt/2 and g = g(t + dt),
//
//   kv3  = A un3 + c0^2 g W1 - c0 W2 vn3,    un3 = u0 + dt (v0 + a kv1)
//   u1   = u0 + dt (((b0 v0 + b1 vn1) + b2 vn2) + b3 vn3)
//   v1   = v0 + dt (((b0 kv0 + b1 kv1) + b2 kv2) + b3 kv3)
//   kv0' = A u1 + c0^2 g W1 - c0 W2 v1       (step 2's stage 0)
//
// with vn1 = v0 + a kv0, vn2 = v0 + a kv1, vn3 = v0 + dt kv2: the
// expressions and association orders of kernel C's stage 3, so that u1
// and v1 are the ones two kernel-C steps give. A is stencil_tiled.cuh's
// stencil in its sum order. u1, v1 and kv0' are written for step
// 2's stages, 0 in the padding; none of them may alias an input.
//
// On a value-halo layout (parallel/sharded_padded.py: a halo of 6p holding
// the neighbour blocks' values, refreshed once per call) the caller passes
// the box grown 2p into the halo (ops/rk42step.py::call_rings): step 2's
// stages read u1 and v1 2p deep and kv0' p deep, and kv0' is exact there
// because the stages before wrote kv0 and kv2 2p deep and kv1 3p deep. The
// kernel is the same: its TMA windows read the inputs p deep around the
// box as they are in memory, it forms un3 and u1 there from them, the face
// terms act on rows src_x and abc_x wherever they fall in the box (the
// global x faces may lie in the halo), and "the padding" it zeroes is
// everything outside the box. The box's TMA z start moves with the box's
// h, and tma_window's oz keeps it 16-byte aligned.
//
// What bounds it on this card: the interiors of five fields in (u0, v0,
// kv0, kv1, kv2; their padding is 0) and three padded fields out (0.0546
// ms in f32 at the P1 size: 5 x 17.11 MB + 3 x 31.85 MB and the tables,
// at 3.35 TB/s); two stencil applies of one multiply-add a tap are far
// below the flop rate. The earlier per-point form applied both stencils
// from global memory and formed un3 (3 loads) and u1 (5 loads) at each of
// the 2 x 3(2p + 1) taps: 216 L1/L2 loads a point at p = 4, 8.4x the
// bound.
//
// The design (kernel D's, rk_stage_tiled.cu): a block owns a ty x tz tile
// of interior (y, z) columns and streams one x-chunk with p warm-up planes
// on each side. Each plane's windows of the five inputs, the tile and its
// p-deep y/z halo, arrive by five TMA requests into a ring of
// boundary_ring<T>() planes (a raw plane is used only until the stage
// inputs are formed, so the ring is shallower than kRing: five fields a
// plane would not leave room for two blocks an SM). un3 and u1 are formed
// once per point of the window's (ty + 2p) x (tz + 2p) halo box, into one
// of two pairs of stage-input planes, by the threads that own the points,
// before the plane's one barrier. The x taps come from two register
// queues of the column's last 2p + 1 un3 and u1 values, the y/z taps from
// the formed planes, the column's y/z tables and W1, W2 entries sit in
// registers, and each plane's two y/z sums wait p planes in register
// queues. v0, kv0, kv1, kv2 at the output row are loaded a plane ahead, so
// their latency hides behind a plane's work. The outputs' padding is
// written by the grid's last layer of blocks (padding_block; last measured
// 5 % faster than first at the P1 size, where the tile blocks take two
// waves). P is a template parameter (p = 1..8).
//
// bf16 state (T = __nv_bfloat16; f32 and f64 take the same code with
// Acc<T> = T): the five fields in, the three out and the tables are bf16
// (BFLOAT16 tensor maps), the arithmetic and dt, g and the c0 terms
// float32, as in kernel C's stages (rk4_tiled.cu). The formed planes hold
// un3 and u1 rounded once, as kernel C stores a stage input and u1; kv3
// stays float32 (it is never stored); v1 is rounded once and kv0' takes
// its face term from v1 as stored, the v1 step 2's stages read; kv0' is
// rounded once. u1, v1 and kv0' are then the ones two kernel-C steps
// store. A plane's five boxes take f32's ring of three.
//
// The extern "C" launcher returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for a tiling that does not fit the layout, too
// little shared memory, an output that aliases an input, or a tensor map that
// cuTensorMapEncodeTiled refuses.

#include <cuda.h>
#include <cuda_runtime.h>

#include "stencil_tiled.cuh"

namespace wave {

// planes in the boundary kernel's TMA ring: five boxes a plane
template <typename T>
__host__ __device__ constexpr int boundary_ring() {
  return sizeof(T) == 8 ? 2 : 3;
}

template <typename T>
struct BoundaryArgs {
  const T* u0;
  const T* v0;
  const T* kv0;
  const T* kv1;
  const T* kv2;
  T* u1;
  T* v1;
  T* kv0_out;
  const T* w1;
  const T* w2;
  int src_x, abc_x;
  Acc<T> dt, g, c0sq, mc0;  // in the arithmetic type: f32 for bf16 state
};

template <typename T, int P>
__global__ void __launch_bounds__(kTileThreads, (tma_min_blocks<T>()))
    rk42_boundary_tiled_kernel(const __grid_constant__ CUtensorMap m_u0,
                               const __grid_constant__ CUtensorMap m_v0,
                               const __grid_constant__ CUtensorMap m_kv0,
                               const __grid_constant__ CUtensorMap m_kv1,
                               const __grid_constant__ CUtensorMap m_kv2,
                               Stencil<T> s, BoundaryArgs<T> a, Tiling t) {
  using A = Acc<T>;
  constexpr int K = 2 * P + 1;
  constexpr int R = boundary_ring<T>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  long long pb, npb;
  if (padding_block(s, t, pb, npb)) {  // the grid's last layer: the outputs' padding
    for_each_padding<1>(s, t, pb, npb, [a](const int (&i)[1], int) {
      a.u1[i[0]] = zero<T>();
      a.v1[i[0]] = zero<T>();
      a.kv0_out[i[0]] = zero<T>();
    });
    return;
  }

  const TileCoords c(s, t);
  const TmaWindow w = tma_window<T>(s, t, P);
  // u0, v0, kv0, kv1, kv2; two pairs of formed planes (un3, u1)
  const PlaneRing<T, R> ring(smem_raw, w, 5, 4);
  const CUtensorMap* maps[5] = {&m_u0, &m_v0, &m_kv0, &m_kv1, &m_kv2};
  const int zs = c.z0 - P - w.oz;  // the box's origin in every plane
  const int ys = c.y0 - P;
  const int iters = c.xe - c.xs + 2 * P;  // planes xs - P .. xe + P - 1
  if (threadIdx.x == 0) {
    for (int i = 0; i < R - 1 && i < iters; ++i) {
      ring.fetch(i, maps, zs, ys, c.xs - P + i);
    }
  }
  ColumnTables<T, P> tab;
  tab.load(s, c.f, c.active);
  const A w1 = c.active ? widen(a.w1[c.f]) : A(0);
  const A w2 = c.active ? widen(a.w2[c.f]) : A(0);
  A q3[K], q1[K];  // un3 and u1 at row gi - 2P + k after plane gi
#pragma unroll
  for (int k = 0; k < K; ++k) q3[k] = q1[k] = A(0);
  A yz3q[P], yz1q[P];  // their y/z sums at row gi - P + 1 + j after plane gi
#pragma unroll
  for (int j = 0; j < P; ++j) yz3q[j] = yz1q[j] = A(0);

  const A dt = a.dt;
  const A hdt = A(0.5) * dt;
  const A b0 = A(1.0 / 6.0);
  const A b1 = A(1.0 / 3.0);
  const int F = s.F();
  const int W = w.W;
  const int box = w.box;
  const int WF = t.tz + 2 * P;    // the formed columns of a window row
  const int npt = w.BY * WF;      // the formed points of a plane
  const int nt = t.ty * t.tz;
  const int co = (c.ly + P) * W + (c.lz + P + w.oz);  // the column in a box
  // v0, kv0, kv1, kv2 at the output row of this plane (pt) and of the next
  // (pn): loaded a plane ahead, so their latency hides behind a plane
  A pt[4], pn[4] = {A(0), A(0), A(0), A(0)};
  for (int i = 0; i < iters; ++i) {
    const int gi = c.xs - P + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) pt[j] = pn[j];
    if (c.active && i + 1 >= 2 * P && i + 1 < iters) {
      const long long nidx = (long long)(gi + 1 - P) * F + c.f;
      pn[0] = widen(a.v0[nidx]);
      pn[1] = widen(a.kv0[nidx]);
      pn[2] = widen(a.kv1[nidx]);
      pn[3] = widen(a.kv2[nidx]);
    }
    ring.wait(i);
    const T* sl = ring.slot(i);
    T* f3 = ring.extra(2 * (i & 1));
    T* f1 = f3 + box;
    for (int e = (int)threadIdx.x; e < npt; e += nt) {
      const int r = e / WF;
      const int j = r * W + w.oz + (e - r * WF);
      const A u0 = widen(sl[j]);
      const A v0 = widen(sl[box + j]);
      const A k0 = widen(sl[2 * box + j]);
      const A k1 = widen(sl[3 * box + j]);
      const A k2 = widen(sl[4 * box + j]);
      f3[j] = narrow<T>(u0 + dt * (v0 + hdt * k1));  // bf16 rounds un3, u1
      const A vn1 = v0 + hdt * k0;
      const A vn2 = v0 + hdt * k1;
      const A vn3 = v0 + dt * k2;
      f1[j] = narrow<T>(u0 + dt * (((b0 * v0 + b1 * vn1) + b1 * vn2) + b0 * vn3));
    }
    __syncthreads();  // un3 and u1 of plane gi are complete, and every
                      // thread is past plane gi - 1: refill its slot
    if (threadIdx.x == 0 && i + R - 1 < iters) {
      ring.fetch(i + R - 1, maps, zs, ys, gi + R - 1);
    }
    const T* c3 = f3 + co;
    const T* c1 = f1 + co;
#pragma unroll
    for (int k = 0; k < K - 1; ++k) {
      q3[k] = q3[k + 1];
      q1[k] = q1[k + 1];
    }
    q3[K - 1] = widen(c3[0]);
    q1[K - 1] = widen(c1[0]);
    const bool in = c.active && gi >= c.xs && gi < c.xe;
    const A yz3_new = in ? tab.yz(c3, W) : A(0);
    const A yz1_new = in ? tab.yz(c1, W) : A(0);
    const A yz3 = yz3q[0];
    const A yz1 = yz1q[0];
#pragma unroll
    for (int j = 0; j < P - 1; ++j) {
      yz3q[j] = yz3q[j + 1];
      yz1q[j] = yz1q[j + 1];
    }
    yz3q[P - 1] = yz3_new;
    yz1q[P - 1] = yz1_new;

    if (i < 2 * P || !c.active) continue;
    const int g = gi - P;  // the output row
    const long long idx = (long long)g * F + c.f;
    const A sxg = widen(__ldg(&s.sx[g]));
    A kv3 = x_taps<A, P>(s, q3, g) * tab.fx + yz3 * sxg;
    if (g == a.src_x) kv3 += (a.c0sq * a.g) * w1;
    if (g == a.abc_x) kv3 += (a.mc0 * w2) * (pt[0] + dt * pt[3]);
    const A accv = ((b0 * pt[1] + b1 * pt[2]) + b1 * pt[3]) + b0 * kv3;
    const T v1 = narrow<T>(pt[0] + dt * accv);
    A kv = x_taps<A, P>(s, q1, g) * tab.fx + yz1 * sxg;
    if (g == a.src_x) kv += (a.c0sq * a.g) * w1;
    if (g == a.abc_x) kv += (a.mc0 * w2) * widen(v1);  // v1 as stored
    a.u1[idx] = narrow<T>(q1[P]);
    a.v1[idx] = v1;
    a.kv0_out[idx] = narrow<T>(kv);
  }
}

template <typename T, int P>
int launch_boundary_p(Stencil<T> s, BoundaryArgs<T> a, Tiling t, dim3 grid,
                      int smem, cudaStream_t stream) {
  const TmaWindow w = tma_window<T>(s, t, P);
  const T* ins[5] = {a.u0, a.v0, a.kv0, a.kv1, a.kv2};
  for (const T* x : ins) {
    if (!tma_fits<T>(s, t, w, x)) return (int)cudaErrorInvalidValue;
  }
  if (smem < tma_smem_bytes<T>(w, 5, 4, boundary_ring<T>())) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap maps[5];
  for (int f = 0; f < 5; ++f) {
    const int e = encode_plane_map<T>(&maps[f], ins[f], s, w);
    if (e != 0) return e;
  }
  auto kernel = rk42_boundary_tiled_kernel<T, P>;
  if (smem > 48 * 1024) {
    const cudaError_t r = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (r != cudaSuccess) return (int)r;
  }
  kernel<<<grid, t.ty * t.tz, smem, stream>>>(maps[0], maps[1], maps[2],
                                              maps[3], maps[4], s, a, t);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rk42_boundary_tiled(Stencil<T> s, BoundaryArgs<T> a, Tiling t,
                               dim3 grid, int smem, cudaStream_t stream) {
  const T* ins[5] = {a.u0, a.v0, a.kv0, a.kv1, a.kv2};
  for (const T* x : ins) {
    if (x == a.u1 || x == a.v1 || x == a.kv0_out) return (int)cudaErrorInvalidValue;
  }
  if (!tma_tiling_fits(t, grid, s.nx, s.ny, s.nz) || !box_fits_int(s) ||
      s.x0 < s.p || s.h < s.p) {
    return (int)cudaErrorInvalidValue;
  }
  switch (s.p) {
    case 1: return launch_boundary_p<T, 1>(s, a, t, grid, smem, stream);
    case 2: return launch_boundary_p<T, 2>(s, a, t, grid, smem, stream);
    case 3: return launch_boundary_p<T, 3>(s, a, t, grid, smem, stream);
    case 4: return launch_boundary_p<T, 4>(s, a, t, grid, smem, stream);
    case 5: return launch_boundary_p<T, 5>(s, a, t, grid, smem, stream);
    case 6: return launch_boundary_p<T, 6>(s, a, t, grid, smem, stream);
    case 7: return launch_boundary_p<T, 7>(s, a, t, grid, smem, stream);
    case 8: return launch_boundary_p<T, 8>(s, a, t, grid, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace wave

// ---------------------------------------------------------------------------
// Plain C interface (bound with ctypes by ops/_cuda.py). The last seven
// ints are ops/rk42step.py::boundary_launch_args's tiling: ty, tz, cx, the
// grid (gx, gy, gz) and the dynamic shared memory in bytes of
// ops/tiling.py::tma_geometry (fields=5, extra=4, ring=boundary_ring).
// ---------------------------------------------------------------------------

#define WAVE_DEFINE_RK42_BOUNDARY_TILED(T, SUFFIX)                            \
  extern "C" int wave_rk42_boundary_tiled_##SUFFIX(                           \
      const T* u0, const T* v0, const T* kv0, const T* kv1, const T* kv2,     \
      T* u1, T* v1, T* kv0_out, const T* w1, const T* w2, int src_x,          \
      int abc_x, double dt, double g, double c0, const T* cvx, const T* sx,   \
      const T* fx, const T* cvy, const T* cvz, int p, int Lx, int Ly, int Lz, \
      int x0, int nx, int h, int ny, int nz, int ty, int tz, int cx, int gx,  \
      int gy, int gz, int smem, cudaStream_t stream) {                        \
    using A = wave::Acc<T>;                                                   \
    wave::BoundaryArgs<T> a{u0, v0, kv0, kv1, kv2, u1, v1, kv0_out, w1, w2,  \
                            src_x, abc_x, (A)dt, (A)g, (A)(c0 * c0),          \
                            (A)(-c0)};                                        \
    wave::Stencil<T> s{cvx, sx, fx, cvy, cvz, p, Lx, Ly, Lz,                  \
                       x0, nx, h, ny, nz};                                    \
    return wave::launch_rk42_boundary_tiled<T>(                               \
        s, a, wave::Tiling{ty, tz, cx}, dim3(gx, gy, gz), smem, stream);      \
  }

WAVE_DEFINE_RK42_BOUNDARY_TILED(float, f32)
WAVE_DEFINE_RK42_BOUNDARY_TILED(double, f64)
WAVE_DEFINE_RK42_BOUNDARY_TILED(__nv_bfloat16, bf16)
