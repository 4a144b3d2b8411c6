// Kernel D on Hopper (sm_90a): one stage of the fused-stage RK4 path, on
// the 2.5D tiled stencil of stencil_tiled.cuh with TMA plane loads.
//
// rk_stage_tiled_kernel<T, P> replaces the TPU kernel
// wave_fenics_tpu/ops/pallas_wave.py::_kernel_rk_stage: with the stage
// input un = u0 + ca ku,
//
//   vn  = v0 + ca kv
//   kv' = A un + c0^2 g W1 (row src_x) - c0 W2 vn (row abc_x), in that order
//   ua' = ua + cb vn                     va' = va + cb kv'
//
// vn and ua' are written at every padded point; in the padding kv' = 0 and
// va' = va, as on the TPU kernel's all-pad tiles. ua'/va' are point-wise
// updates and may be ua/va themselves (solve_fused_n passes them so); vn
// and kv' alias nothing. The stencil is stencil_tiled.cuh's, in its sum
// order (x_taps, ColumnTables::yz).
//
// What bounds it on this card: the interiors of the six fields it reads
// (their padding is 0) and the four padded fields it writes (0.067 ms in
// f32 at the P4 size: 6 x 17.11 MB + 4 x 29.57 MB and the tables, at 3.35
// TB/s); one multiply-add per tap is far below the flop rate. The earlier
// per-point form formed u0 + ca ku at each of its 51 taps (p = 8) from two
// global loads: bound by load issue at 5.4x.
//
// The design: a block owns a ty x tz tile of interior (y, z) columns and
// streams one x-chunk (stencil_tiled.cuh). Each plane's windows of u0 and
// ku, the tile and its p-deep y/z halo, arrive by two TMA requests into a
// ring of kRing planes, kRing - 1 planes ahead; un is formed once per
// window point into one of two stage-input planes by the thread that owns
// the point, before the plane's one barrier, as kernel A forms its stage
// input. The x taps come from a register queue of the column's last
// 2p + 1 un values, the y/z taps from the stage-input plane, the column's
// y/z tables sit in registers, and a plane's y/z sum waits p planes in a
// second register queue. The point-wise fields (v0, kv, ua, va) of the
// output row are loaded a plane ahead, so that their latency hides behind
// a plane's work instead of stalling every plane. The padding (42 % of
// the P4 box, four fields read and four written a point) is a point-wise
// pass of the grid's last layer of blocks (padding_block), eight points a
// thread with their loads ahead of their stores, in the block slots the
// tile blocks leave free, while those stream. P is a
// template parameter (p = 1..8); the launch bounds ask for two 256-thread
// blocks an SM in f32.
//
// bf16 state: the six fields, the four outputs, the two un planes and the
// tables are bf16, the arithmetic and ca, cb, g and the c0 terms float32;
// each output is rounded once, and ua' and va' add vn and kv' as stored
// (the values the next stage reads: accumulating the float32 values
// instead doubled the fused solve's error in v, 1.03e-2 against the
// f64 answer where this gives 5.7e-3, tests/test_torch_bf16.py).
//
// The extern "C" launcher returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for a tiling that does not fit the layout or a
// tensor map the driver refuses.

#include <cuda.h>
#include <cuda_runtime.h>

#include "stencil_tiled.cuh"

namespace wave {

template <typename T>
struct RkStageArgs {
  const T* u0;
  const T* ku;
  const T* v0;
  const T* kv;
  const T* ua;
  const T* va;
  T* vn_out;
  T* kv_out;
  T* ua_out;
  T* va_out;
  const T* w1;
  const T* w2;
  int src_x, abc_x;
  Acc<T> ca, cb, g, c0sq, mc0;  // in the arithmetic type: f32 for bf16 state
};

template <typename T, int P>
__global__ void __launch_bounds__(kTileThreads, (tma_min_blocks<T>()))
    rk_stage_tiled_kernel(const __grid_constant__ CUtensorMap umap,
                          const __grid_constant__ CUtensorMap kumap,
                          Stencil<T> s, RkStageArgs<T> a, Tiling t) {
  using A = Acc<T>;
  constexpr int K = 2 * P + 1;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const A ca = a.ca;
  const A cb = a.cb;
  long long pb, npb;
  if (padding_block(s, t, pb, npb)) {
    // the grid's last layer: the padding, eight points a thread at a time,
    // their loads issued before their stores
    for_each_padding<8>(s, t, pb, npb, [a, ca, cb](const int (&i)[8], int n) {
      T v[8], k[8], u[8], w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < n) {
          v[j] = a.v0[i[j]];
          k[j] = a.kv[i[j]];
          u[j] = a.ua[i[j]];
          w[j] = a.va[i[j]];
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < n) {
          const T vn = narrow<T>(widen(v[j]) + ca * widen(k[j]));
          a.vn_out[i[j]] = vn;
          a.kv_out[i[j]] = zero<T>();
          a.ua_out[i[j]] = narrow<T>(widen(u[j]) + cb * widen(vn));
          a.va_out[i[j]] = w[j];
        }
      }
    });
    return;
  }

  const TileCoords c(s, t);
  const TmaWindow w = tma_window<T>(s, t, P);
  const PlaneRing<T> ring(smem_raw, w, 2, 2);  // u0, ku; two un planes
  const int zs = c.z0 - P - w.oz;  // the box's origin in every plane
  const int ys = c.y0 - P;
  const int iters = c.xe - c.xs + 2 * P;  // planes xs - P .. xe + P - 1
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing - 1 && i < iters; ++i) {
      ring.fetch(i, &umap, &kumap, zs, ys, c.xs - P + i);
    }
  }
  ColumnTables<T, P> tab;
  tab.load(s, c.f, c.active);
  A q[K];  // q[k] = un at row gi - 2P + k after plane gi
#pragma unroll
  for (int k = 0; k < K; ++k) q[k] = A(0);
  A yzq[P];  // yzq[j] = the y/z sum at row gi - P + 1 + j after plane gi
#pragma unroll
  for (int j = 0; j < P; ++j) yzq[j] = A(0);

  const int F = s.F();
  const int W = w.W;
  const int npt = W * w.BY;  // window points a plane's un takes
  const int nt = t.ty * t.tz;
  const int co = (c.ly + P) * W + (c.lz + P + w.oz);  // the column in a box
  // v0, kv, ua, va at the output row of this plane (pt) and of the next
  // (pn): loaded a plane ahead, so their latency hides behind a plane
  A pt[4], pn[4] = {A(0), A(0), A(0), A(0)};
  for (int i = 0; i < iters; ++i) {
    const int gi = c.xs - P + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) pt[j] = pn[j];
    if (c.active && i + 1 >= 2 * P && i + 1 < iters) {
      const long long nidx = (long long)(gi + 1 - P) * F + c.f;
      pn[0] = widen(a.v0[nidx]);
      pn[1] = widen(a.kv[nidx]);
      pn[2] = widen(a.ua[nidx]);
      pn[3] = widen(a.va[nidx]);
    }
    ring.wait(i);
    const T* ub = ring.slot(i);
    const T* kb = ub + w.box;
    T* un = ring.extra(i & 1);
    for (int e = (int)threadIdx.x; e < npt; e += nt) {
      un[e] = narrow<T>(widen(ub[e]) + ca * widen(kb[e]));  // bf16 rounds un
    }
    __syncthreads();  // un of plane gi is complete, and every thread is past
                      // plane gi - 1: refill its slot
    if (threadIdx.x == 0 && i + kRing - 1 < iters) {
      ring.fetch(i + kRing - 1, &umap, &kumap, zs, ys, gi + kRing - 1);
    }
    const T* ctr = un + co;
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
    A kv = tx * tab.fx + yz * widen(__ldg(&s.sx[g]));
    if (g == a.src_x) kv += (a.c0sq * a.g) * widen(a.w1[c.f]);
    const A vn = pt[0] + ca * pt[1];
    if (g == a.abc_x) kv += (a.mc0 * widen(a.w2[c.f])) * vn;
    // ua' and va' add vn and kv' as stored (bf16 rounds them first), the
    // values the next stage reads
    const T vn_s = narrow<T>(vn);
    const T kv_s = narrow<T>(kv);
    a.vn_out[idx] = vn_s;
    a.kv_out[idx] = kv_s;
    a.ua_out[idx] = narrow<T>(pt[2] + cb * widen(vn_s));
    a.va_out[idx] = narrow<T>(pt[3] + cb * widen(kv_s));
  }
}

template <typename T, int P>
int launch_stage_tiled(Stencil<T> s, RkStageArgs<T> a, Tiling t, dim3 grid,
                       int smem, cudaStream_t stream) {
  const TmaWindow w = tma_window<T>(s, t, P);
  if (!tma_fits<T>(s, t, w, a.u0) || !tma_fits<T>(s, t, w, a.ku) ||
      smem < tma_smem_bytes<T>(w, 2, 2)) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap umap, kumap;
  int e = encode_plane_map<T>(&umap, a.u0, s, w);
  if (e == 0) e = encode_plane_map<T>(&kumap, a.ku, s, w);
  if (e != 0) return e;
  auto kernel = rk_stage_tiled_kernel<T, P>;
  if (smem > 48 * 1024) {
    const cudaError_t r = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (r != cudaSuccess) return (int)r;
  }
  kernel<<<grid, t.ty * t.tz, smem, stream>>>(umap, kumap, s, a, t);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rk_stage_tiled(Stencil<T> s, RkStageArgs<T> a, Tiling t, dim3 grid,
                          int smem, cudaStream_t stream) {
  if (!tma_tiling_fits(t, grid, s.nx, s.ny, s.nz) || !box_fits_int(s) ||
      s.x0 < s.p || s.h < s.p) {
    return (int)cudaErrorInvalidValue;
  }
  switch (s.p) {
    case 1: return launch_stage_tiled<T, 1>(s, a, t, grid, smem, stream);
    case 2: return launch_stage_tiled<T, 2>(s, a, t, grid, smem, stream);
    case 3: return launch_stage_tiled<T, 3>(s, a, t, grid, smem, stream);
    case 4: return launch_stage_tiled<T, 4>(s, a, t, grid, smem, stream);
    case 5: return launch_stage_tiled<T, 5>(s, a, t, grid, smem, stream);
    case 6: return launch_stage_tiled<T, 6>(s, a, t, grid, smem, stream);
    case 7: return launch_stage_tiled<T, 7>(s, a, t, grid, smem, stream);
    case 8: return launch_stage_tiled<T, 8>(s, a, t, grid, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace wave

// ---------------------------------------------------------------------------
// Plain C interface (bound with ctypes by ops/_cuda.py). The last seven
// ints are ops/rk4step.py::tma_geometry's tiling: ty, tz, cx, the grid
// (gx, gy, gz) and the dynamic shared memory in bytes.
// ---------------------------------------------------------------------------

#define WAVE_DEFINE_RK_STAGE_TILED(T, SUFFIX)                                 \
  extern "C" int wave_rk_stage_tiled_##SUFFIX(                                \
      const T* u0, const T* ku, const T* v0, const T* kv, const T* ua,        \
      const T* va, T* vn_out, T* kv_out, T* ua_out, T* va_out, const T* w1,   \
      const T* w2, int src_x, int abc_x, double ca, double cb, double g,      \
      double c0, const T* cvx, const T* sx, const T* fx, const T* cvy,        \
      const T* cvz, int p, int Lx, int Ly, int Lz, int x0, int nx, int h,     \
      int ny, int nz, int ty, int tz, int cx, int gx, int gy, int gz,         \
      int smem, cudaStream_t stream) {                                        \
    using A = wave::Acc<T>;                                                   \
    wave::RkStageArgs<T> a{u0, ku, v0, kv, ua, va, vn_out, kv_out, ua_out,    \
                           va_out, w1, w2, src_x, abc_x, (A)ca, (A)cb, (A)g,  \
                           (A)(c0 * c0), (A)(-c0)};                           \
    wave::Stencil<T> s{cvx, sx, fx, cvy, cvz, p, Lx, Ly, Lz,                  \
                       x0, nx, h, ny, nz};                                    \
    return wave::launch_rk_stage_tiled<T>(s, a, wave::Tiling{ty, tz, cx},     \
                                          dim3(gx, gy, gz), smem, stream);    \
  }

WAVE_DEFINE_RK_STAGE_TILED(float, f32)
WAVE_DEFINE_RK_STAGE_TILED(double, f64)
WAVE_DEFINE_RK_STAGE_TILED(__nv_bfloat16, bf16)
