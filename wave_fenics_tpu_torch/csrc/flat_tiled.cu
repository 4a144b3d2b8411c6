// Kernel B on Hopper (sm_90a): y = A x on the flat padded layout, on the
// 2.5D tiled stencil of stencil_tiled.cuh with TMA plane loads.
//
// apply_flat_tiled_kernel<T, P> replaces the TPU kernel
// wave_fenics_tpu/ops/pallas_wave.py::_kernel_flat: y = A x = -c0^2 (K x)/m
// on the flat padded layout (p <= 8, ops/wave.py::PaddedLayout.check_flat).
// At an interior point, with the stencil tables of stencil.cuh (Stencil),
//
//   y = tx fx + yz sx
//
// with tx the x taps in k order (x_taps) and yz the merged shift-0 y/z
// tap, the other y taps, then the other z taps (ColumnTables::yz); every
// other padded point of y is 0, whatever the output buffer held.
//
// What bounds it on this card: x's interior read once (its padding is 0)
// and the whole padded y written once (17.11 + 31.85 MB in f32 at the P1
// layout, (384, 144, 144) at p = 4: 0.0151 ms at 3.35 TB/s with the
// tables); one multiply-add per tap is far below the flop rate. The
// earlier per-point form loaded all 27 taps of a point from L1/L2, and 62 %
// of its threads only wrote a padding 0: 8.8x that bound.
//
// The design (kernel E's, slab_tiled.cu, on the flat layout's tables; the
// stencil of kernel H's OPEN phase, lf_tiled.cu): a block owns a ty x tz
// tile of interior (y, z) columns and streams one x-chunk. Each plane's
// window of x, the tile and its p-deep y/z halo, arrives by one TMA
// request into a ring of kRing planes, kRing - 1 planes ahead; the x taps
// come from a register queue of the column's last 2p + 1 plane values, the
// y/z taps from the window, the column's cvy, cvz and fx sit in registers
// for the whole chunk, and a plane's y/z sum waits p planes in a second
// register queue until the row's x sum is complete. The tile blocks write
// only interior points; y's padding is written by one layer of blocks
// (padding_block), the grid's first (kPaddingFirst, chosen by measurement
// at the P1 layout). P is a template
// parameter (p = 1..8); the launch bounds ask for two 256-thread blocks an
// SM in f32.
//
// bf16 state: a bf16 x and tables (a BFLOAT16 tensor map, 8 points a
// 16-byte unit), the sums in float32, y rounded once.
//
// The extern "C" launcher returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for a tiling that does not fit the layout, y
// aliasing x, or a tensor map the driver refuses.

#include <cuda.h>
#include <cuda_runtime.h>

#include "stencil_tiled.cuh"

namespace wave {

// Whether y's padding layer is the grid's first (else its last): first,
// its blocks share the first wave of tile blocks (at the P1 layout 525
// tile blocks take two waves); measured 15 % faster than last there.
constexpr bool kPaddingFirst = true;

template <typename T, int P>
__global__ void __launch_bounds__(kTileThreads, (tma_min_blocks<T>()))
    apply_flat_tiled_kernel(const __grid_constant__ CUtensorMap xmap,
                            T* __restrict__ y, Stencil<T> s, Tiling t) {
  constexpr int K = 2 * P + 1;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  long long pb, npb;
  if (padding_block<kPaddingFirst>(s, t, pb, npb)) {  // y's padding
    for_each_padding<1>(s, t, pb, npb,
                        [y](const int (&i)[1], int) { y[i[0]] = zero<T>(); });
    return;
  }
  using A = Acc<T>;

  const TileCoords c(s, t, kPaddingFirst ? padding_layers(s, t) : 0);
  const TmaWindow w = tma_window<T>(s, t, P);
  const PlaneRing<T> ring(smem_raw, w, 1, 0);
  const int zs = c.z0 - P - w.oz;  // the box's origin in every plane
  const int ys = c.y0 - P;
  const int iters = c.xe - c.xs + 2 * P;  // planes xs - P .. xe + P - 1
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing - 1 && i < iters; ++i) {
      ring.fetch(i, &xmap, nullptr, zs, ys, c.xs - P + i);
    }
  }
  ColumnTables<T, P> tab;
  tab.load(s, c.f, c.active);
  A q[K];  // q[k] = x at row gi - 2P + k after plane gi
#pragma unroll
  for (int k = 0; k < K; ++k) q[k] = A(0);
  A yzq[P];  // yzq[j] = the y/z sum at row gi - P + 1 + j after plane gi
#pragma unroll
  for (int j = 0; j < P; ++j) yzq[j] = A(0);

  const int F = s.F();
  const int W = w.W;
  const int co = (c.ly + P) * W + (c.lz + P + w.oz);  // the column in a box
  for (int i = 0; i < iters; ++i) {
    const int gi = c.xs - P + i;
    ring.wait(i);
    __syncthreads();  // every thread is past plane gi - 1: refill its slot
    if (threadIdx.x == 0 && i + kRing - 1 < iters) {
      ring.fetch(i + kRing - 1, &xmap, nullptr, zs, ys, gi + kRing - 1);
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
    const A yg = x_taps<A, P>(s, q, g) * tab.fx + yz * widen(__ldg(&s.sx[g]));
    y[(long long)g * F + c.f] = narrow<T>(yg);
  }
}

template <typename T, int P>
int launch_flat(const T* x, T* y, Stencil<T> s, Tiling t, dim3 grid, int smem,
                cudaStream_t stream) {
  const TmaWindow w = tma_window<T>(s, t, P);
  if (!tma_fits<T>(s, t, w, x) || smem < tma_smem_bytes<T>(w, 1, 0)) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap xmap;
  const int e = encode_plane_map<T>(&xmap, x, s, w);
  if (e != 0) return e;
  auto kernel = apply_flat_tiled_kernel<T, P>;
  if (smem > 48 * 1024) {
    const cudaError_t r = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (r != cudaSuccess) return (int)r;
  }
  kernel<<<grid, t.ty * t.tz, smem, stream>>>(xmap, y, s, t);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_apply_flat_tiled(const T* x, T* y, Stencil<T> s, Tiling t,
                            dim3 grid, int smem, cudaStream_t stream) {
  if (!tma_tiling_fits(t, grid, s.nx, s.ny, s.nz) || !box_fits_int(s) ||
      s.x0 < s.p || s.h < s.p || x == y) {
    return (int)cudaErrorInvalidValue;
  }
  switch (s.p) {
    case 1: return launch_flat<T, 1>(x, y, s, t, grid, smem, stream);
    case 2: return launch_flat<T, 2>(x, y, s, t, grid, smem, stream);
    case 3: return launch_flat<T, 3>(x, y, s, t, grid, smem, stream);
    case 4: return launch_flat<T, 4>(x, y, s, t, grid, smem, stream);
    case 5: return launch_flat<T, 5>(x, y, s, t, grid, smem, stream);
    case 6: return launch_flat<T, 6>(x, y, s, t, grid, smem, stream);
    case 7: return launch_flat<T, 7>(x, y, s, t, grid, smem, stream);
    case 8: return launch_flat<T, 8>(x, y, s, t, grid, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace wave

// Plain C interface (bound with ctypes by ops/_cuda.py). The last seven
// ints are ops/tiling.py::tma_geometry's tiling (fields=1, extra=0): ty,
// tz, cx, the grid (gx, gy, gz) and the dynamic shared memory in bytes.
#define WAVE_DEFINE_APPLY_FLAT_TILED(T, SUFFIX)                               \
  extern "C" int wave_apply_flat_tiled_##SUFFIX(                              \
      const T* x, T* y, const T* cvx, const T* sx, const T* fx, const T* cvy, \
      const T* cvz, int p, int Lx, int Ly, int Lz, int x0, int nx, int h,     \
      int ny, int nz, int ty, int tz, int cx, int gx, int gy, int gz,         \
      int smem, cudaStream_t stream) {                                        \
    wave::Stencil<T> s{cvx, sx, fx, cvy, cvz, p, Lx, Ly, Lz,                  \
                       x0, nx, h, ny, nz};                                    \
    return wave::launch_apply_flat_tiled<T>(x, y, s, wave::Tiling{ty, tz, cx}, \
                                            dim3(gx, gy, gz), smem, stream);  \
  }

WAVE_DEFINE_APPLY_FLAT_TILED(float, f32)
WAVE_DEFINE_APPLY_FLAT_TILED(double, f64)
WAVE_DEFINE_APPLY_FLAT_TILED(__nv_bfloat16, bf16)

// The CUDA error's name for a launcher's return code (ops/_cuda.py).
extern "C" const char* wave_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
