// Kernels H and I on Hopper (sm_90a): the phases of kick-drift-kick
// leapfrog, on the 2.5D tiled stencil of stencil_tiled.cuh with TMA plane
// loads.
//
// lf_phase_tiled_kernel<T, P, Phase> replaces the TPU kernels
// wave_fenics_tpu/ops/pallas_lfstep.py::_kernel_lf_step (OPEN + CLOSE: one
// leapfrog step, kernel H) and pallas_lf2step.py::_kernel_lf2_step (OPEN +
// MID + CLOSE: two leapfrog steps, the step-boundary force computed once,
// kernel I). With F(u) = A u + c0^2 g W1 (row src_x), D = c0 W2 (row
// abc_x) and h = dt/2:
//
//   OPEN  (u0, v0):  v+ = (v0 + h F(u0)) / (1 + h D),  u1 = u0 + dt v+
//   MID   (u1, v+):  v1 = (1 - h D) v+ + h F(u1),
//                    v+' = (v1 + h F(u1)) / (1 + h D),  u2 = u1 + dt v+'
//   CLOSE (u1, v+):  v1 = (1 - h D) v+ + h F(u1)
//
// A u is stencil_tiled.cuh's stencil in its sum order, then the source
// term, then the phase's formula as written. `u` is read at the taps, so
// u_out must not alias it; CLOSE writes v_out only (u1 stays where OPEN or
// MID wrote it). In the padding, u_out (OPEN, MID) and v_out are 0.
//
// On a value-halo layout (parallel/sharded_padded.py: a halo of 2p for
// one step, 3p for two, holding the neighbour blocks' values) the caller
// passes each phase's box grown into the halo by the depth at which the
// next phase reads its u at the taps (ops/lfstep.py::phase_rings: OPEN p
// in a step; OPEN 2p, MID p in two), CLOSE the interior. The kernel is the
// same: its TMA windows read the halo as it is in memory, and "the
// padding" it zeroes is everything outside the box.
//
// What bounds it on this card: the fields each phase must move, OPEN the
// interiors of u, v in (their padding is 0) and the padded u_out, v_out
// out (0.029 ms in f32 at the P3 size: 2 x 17.11 MB + 2 x 29.57 MB and
// the tables, at 3.35 TB/s), MID the same, CLOSE one padded field out; one
// multiply-add per tap is far below the flop rate. The earlier per-point
// form loaded every tap of a point (51 at p = 8) from L1/L2: HBM ran at
// 10-31 % of its rate.
//
// The design (kernel D's, rk_stage_tiled.cu): a block owns a ty x tz tile
// of interior (y, z) columns and streams one x-chunk. Each plane's window
// of u, the tile and its p-deep y/z halo, arrives by one TMA request into
// a ring of kRing planes, kRing - 1 planes ahead. The x taps come from a
// register queue of the column's last 2p + 1 plane values, whose middle is
// u at the output point, the y/z taps from the window, the column's y/z
// tables and its W1, W2 entries sit in registers, and a plane's y/z sum
// waits p planes in a second register queue. v at the output row is
// loaded a plane ahead, so its latency hides behind a plane's work. The
// outputs' padding is written by one layer of blocks (padding_block): the
// grid's last where the tile blocks fit one wave of the card's block
// slots, else its first, so that it runs beside the first wave of tile
// blocks instead of after the last (the caller decides,
// ops/tiling.py::tma_padding_first). P is a template parameter
// (p = 1..8; the leapfrog at p = 9-10 runs on `force` with kernel E); the
// launch bounds ask for two 256-thread blocks an SM in f32 and bf16.
//
// bf16 state (T = __nv_bfloat16; f32 and f64 take the same code with
// Acc<T> = T): u, v, the outputs and the tables are bf16 (a BFLOAT16
// tensor map, 8 points a 16-byte unit), the arithmetic and dt, g and the
// c0 terms float32 (stencil_tiled.cuh::Acc; the TPU kernels round them to
// the state dtype). Each stored field is rounded once: OPEN and MID round
// v+ and form u_out from v+ as stored, the value CLOSE reads; MID's v1
// stays float32 (it is never stored); CLOSE rounds v1.
//
// The extern "C" launcher returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for a tiling that does not fit the layout, an
// u_out that aliases u, or a tensor map the driver refuses.

#include <cuda.h>
#include <cuda_runtime.h>

#include "stencil_tiled.cuh"

namespace wave {

enum LfPhase { kLfOpen = 0, kLfMid = 1, kLfClose = 2 };

template <typename T>
struct LfArgs {
  const T* u;  // u0 (OPEN) or u1 (MID, CLOSE), read at the taps
  const T* v;  // v0 (OPEN) or v+ (MID, CLOSE)
  T* u_out;    // OPEN: u1; MID: u2; CLOSE: unused
  T* v_out;    // OPEN: v+; MID: v+'; CLOSE: v1
  const T* w1;
  const T* w2;
  int src_x, abc_x;
  Acc<T> dt, g, c0sq, c0;  // in the arithmetic type: f32 for bf16 state
  bool padding_first;  // the padding layer is the grid's first, else its last
};

template <typename T, int P, int Phase>
__global__ void __launch_bounds__(kTileThreads, (tma_min_blocks<T>()))
    lf_phase_tiled_kernel(const __grid_constant__ CUtensorMap umap,
                          Stencil<T> s, LfArgs<T> a, Tiling t) {
  using A = Acc<T>;
  constexpr int K = 2 * P + 1;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  long long pb, npb;
  if (a.padding_first ? padding_block<true>(s, t, pb, npb)
                      : padding_block<false>(s, t, pb, npb)) {  // the outputs' padding
    for_each_padding<1>(s, t, pb, npb, [a](const int (&i)[1], int) {
      if (Phase != kLfClose) a.u_out[i[0]] = zero<T>();
      a.v_out[i[0]] = zero<T>();
    });
    return;
  }

  const TileCoords c(s, t, a.padding_first ? padding_layers(s, t) : 0);
  const TmaWindow w = tma_window<T>(s, t, P);
  const PlaneRing<T> ring(smem_raw, w, 1, 0);
  const int zs = c.z0 - P - w.oz;  // the box's origin in every plane
  const int ys = c.y0 - P;
  const int iters = c.xe - c.xs + 2 * P;  // planes xs - P .. xe + P - 1
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing - 1 && i < iters; ++i) {
      ring.fetch(i, &umap, nullptr, zs, ys, c.xs - P + i);
    }
  }
  ColumnTables<T, P> tab;
  tab.load(s, c.f, c.active);
  const A w1 = c.active ? widen(a.w1[c.f]) : A(0);
  const A w2 = c.active ? widen(a.w2[c.f]) : A(0);
  A q[K];  // q[k] = u at row gi - 2P + k after plane gi
#pragma unroll
  for (int k = 0; k < K; ++k) q[k] = A(0);
  A yzq[P];  // yzq[j] = the y/z sum at row gi - P + 1 + j after plane gi
#pragma unroll
  for (int j = 0; j < P; ++j) yzq[j] = A(0);

  const int F = s.F();
  const int W = w.W;
  const int co = (c.ly + P) * W + (c.lz + P + w.oz);  // the column in a box
  const A dt = a.dt;
  const A h = dt * A(0.5);
  const A one = A(1);
  // v at the output row of this plane (vt) and of the next (vn): loaded a
  // plane ahead, so its latency hides behind a plane
  A vt, vn = A(0);
  for (int i = 0; i < iters; ++i) {
    const int gi = c.xs - P + i;
    vt = vn;
    if (c.active && i + 1 >= 2 * P && i + 1 < iters) {
      vn = widen(a.v[(long long)(gi + 1 - P) * F + c.f]);
    }
    ring.wait(i);
    __syncthreads();  // every thread is past plane gi - 1: refill its slot
    if (threadIdx.x == 0 && i + kRing - 1 < iters) {
      ring.fetch(i + kRing - 1, &umap, nullptr, zs, ys, gi + kRing - 1);
    }
    const T* ctr = ring.slot(i) + co;
#pragma unroll
    for (int k = 0; k < K - 1; ++k) q[k] = q[k + 1];
    q[K - 1] = widen(ctr[0]);
    const A yz_new =
        c.active && gi >= c.xs && gi < c.xe ? tab.yz(ctr, W) : A(0);
    const A yz = yzq[0];
#pragma unroll
    for (int j = 0; j < P - 1; ++j) yzq[j] = yzq[j + 1];
    yzq[P - 1] = yz_new;

    if (i < 2 * P || !c.active) continue;
    const int g = gi - P;  // the output row
    const long long idx = (long long)g * F + c.f;
    const A tx = x_taps<A, P>(s, q, g);
    A force = tx * tab.fx + yz * widen(__ldg(&s.sx[g]));
    if (g == a.src_x) force += (a.c0sq * a.g) * w1;
    const A d = g == a.abc_x ? a.c0 * w2 : A(0);
    if (Phase == kLfOpen) {
      // u1 drifts with v+ as stored (bf16 rounds it), the v+ CLOSE reads
      const T vplus = narrow<T>((vt + h * force) / (one + h * d));
      a.v_out[idx] = vplus;
      a.u_out[idx] = narrow<T>(q[P] + dt * widen(vplus));
    } else {
      const A v1 = (one - h * d) * vt + h * force;
      if (Phase == kLfClose) {
        a.v_out[idx] = narrow<T>(v1);
      } else {
        const T vplus = narrow<T>((v1 + h * force) / (one + h * d));
        a.v_out[idx] = vplus;
        a.u_out[idx] = narrow<T>(q[P] + dt * widen(vplus));
      }
    }
  }
}

template <typename T, int P, int Phase>
int launch_lf_kernel(const CUtensorMap& umap, Stencil<T> s, LfArgs<T> a,
                     Tiling t, dim3 grid, int smem, cudaStream_t stream) {
  auto kernel = lf_phase_tiled_kernel<T, P, Phase>;
  if (smem > 48 * 1024) {
    const cudaError_t r = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (r != cudaSuccess) return (int)r;
  }
  kernel<<<grid, t.ty * t.tz, smem, stream>>>(umap, s, a, t);
  return (int)cudaGetLastError();
}

template <typename T, int P>
int launch_lf_tiled(int phase, Stencil<T> s, LfArgs<T> a, Tiling t, dim3 grid,
                    int smem, cudaStream_t stream) {
  const TmaWindow w = tma_window<T>(s, t, P);
  if (!tma_fits<T>(s, t, w, a.u) || smem < tma_smem_bytes<T>(w, 1, 0)) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap umap;
  const int e = encode_plane_map<T>(&umap, a.u, s, w);
  if (e != 0) return e;
  switch (phase) {
    case kLfOpen: return launch_lf_kernel<T, P, kLfOpen>(umap, s, a, t, grid, smem, stream);
    case kLfMid: return launch_lf_kernel<T, P, kLfMid>(umap, s, a, t, grid, smem, stream);
    case kLfClose: return launch_lf_kernel<T, P, kLfClose>(umap, s, a, t, grid, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_lf_phase_tiled(int phase, Stencil<T> s, LfArgs<T> a, Tiling t,
                          dim3 grid, int smem, cudaStream_t stream) {
  if (!tma_tiling_fits(t, grid, s.nx, s.ny, s.nz) || !box_fits_int(s) ||
      s.x0 < s.p || s.h < s.p || a.v_out == nullptr ||
      (phase != kLfClose && (a.u_out == nullptr || a.u_out == a.u))) {
    return (int)cudaErrorInvalidValue;
  }
  switch (s.p) {
    case 1: return launch_lf_tiled<T, 1>(phase, s, a, t, grid, smem, stream);
    case 2: return launch_lf_tiled<T, 2>(phase, s, a, t, grid, smem, stream);
    case 3: return launch_lf_tiled<T, 3>(phase, s, a, t, grid, smem, stream);
    case 4: return launch_lf_tiled<T, 4>(phase, s, a, t, grid, smem, stream);
    case 5: return launch_lf_tiled<T, 5>(phase, s, a, t, grid, smem, stream);
    case 6: return launch_lf_tiled<T, 6>(phase, s, a, t, grid, smem, stream);
    case 7: return launch_lf_tiled<T, 7>(phase, s, a, t, grid, smem, stream);
    case 8: return launch_lf_tiled<T, 8>(phase, s, a, t, grid, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace wave

// ---------------------------------------------------------------------------
// Plain C interface (bound with ctypes by ops/_cuda.py). The last eight
// ints are ops/tiling.py::tma_geometry's tiling (fields=1, extra=0): ty,
// tz, cx, the grid (gx, gy, gz), the dynamic shared memory in bytes, and
// whether the padding layer goes first (tma_padding_first).
// ---------------------------------------------------------------------------

#define WAVE_DEFINE_LF_PHASE_TILED(T, SUFFIX)                                 \
  extern "C" int wave_lf_phase_tiled_##SUFFIX(                                \
      int phase, const T* u, const T* v, T* u_out, T* v_out, const T* w1,     \
      const T* w2, int src_x, int abc_x, double dt, double g, double c0,      \
      const T* cvx, const T* sx, const T* fx, const T* cvy, const T* cvz,     \
      int p, int Lx, int Ly, int Lz, int x0, int nx, int h, int ny, int nz,   \
      int ty, int tz, int cx, int gx, int gy, int gz, int smem,               \
      int padding_first, cudaStream_t stream) {                               \
    using A = wave::Acc<T>;                                                   \
    wave::LfArgs<T> a{u, v, u_out, v_out, w1, w2, src_x, abc_x, (A)dt, (A)g,  \
                      (A)(c0 * c0), (A)c0, padding_first != 0};               \
    wave::Stencil<T> s{cvx, sx, fx, cvy, cvz, p, Lx, Ly, Lz,                  \
                       x0, nx, h, ny, nz};                                    \
    return wave::launch_lf_phase_tiled<T>(phase, s, a,                        \
                                          wave::Tiling{ty, tz, cx},           \
                                          dim3(gx, gy, gz), smem, stream);    \
  }

WAVE_DEFINE_LF_PHASE_TILED(float, f32)
WAVE_DEFINE_LF_PHASE_TILED(double, f64)
WAVE_DEFINE_LF_PHASE_TILED(__nv_bfloat16, bf16)
