// Kernel E on Hopper (sm_90a): y = A x on the 3D-slab layout, on the 2.5D
// tiled stencil of stencil_tiled.cuh with TMA plane loads.
//
// apply_slab_tiled_kernel<T, P> replaces the TPU kernel
// wave_fenics_tpu/ops/pallas_wave.py::_kernel: y = A x = -c0^2 (K x)/m on
// the padded [Lx, Ly, Lz] state with z aligned to 128, the layout the JAX
// package takes for p > 8 (the flat layout's 8-deep halo window holds
// p <= 8) or kernel='3d'. At an interior point, in the slab tables' form
// (stencil.cuh, SlabStencil),
//
//   y = (tx lyz[y, z] + ty lxz[x, z]) + tz lxy[x, y]
//
// with tx, ty, tz the x, y and z tap sums of 2p + 1 taps each (63 at
// p = 10), ty and tz starting from their shift-0 tap. Every other padded
// point of y is 0, whatever the output buffer held.
//
// What bounds it on this card: one multiply-add per tap is far below the
// flop rate, so the compulsory cost is memory: the interior of x read once
// and the whole padded y written once (at p = 10, cells 26x13x13: 17.9 MB
// in and 47.3 MB out in f32, about 0.02 ms at 3.35 TB/s). The earlier
// per-point form loaded all 63 taps of a point from L1/L2, and 62 % of its
// threads only wrote a padding 0: it ran at 12x that bound.
//
// The design: a block owns a ty x tz tile of interior (y, z) columns and
// streams one x-chunk (stencil_tiled.cuh). Each plane's window, the tile
// and its p-deep y/z halo, arrives by one TMA request into a ring of kRing
// planes, kRing - 1 planes ahead; the x taps come from a register queue of
// the column's last 2p + 1 plane values, the y/z taps from the window, and
// the column's cvy/cvz coefficients and lyz sit in registers for the whole
// chunk. A plane's two y/z terms (ty lxz and tz lxy at that plane's row)
// wait p planes in two register queues until the row's x sum is complete.
// The window is read as the state holds it: its padding is zero and no
// tap of an interior point leaves the state, so no element is zero-filled.
// The tile blocks write only interior points; the outputs' padding (62 %
// of y at the P12 size) is written by the grid's last layer of blocks
// (padding_block) while the tile blocks stream. P is a template parameter
// (p = 1..10)
// so the queues and tables are registers; the launch bounds ask for two
// 256-thread blocks an SM in f32 and bf16.
//
// bf16 state (T = __nv_bfloat16; f32 and f64 take the same code with
// Acc<T> = T): x, y and the six tables are bf16 (a BFLOAT16 tensor map),
// the taps and sums float32 (stencil_tiled.cuh::Acc), y rounded once.
//
// The extern "C" launcher returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for a tiling that does not fit the layout or a
// tensor map the driver refuses.

#include <cuda.h>
#include <cuda_runtime.h>

#include "stencil_tiled.cuh"

namespace wave {

template <typename T, int P>
__global__ void __launch_bounds__(kTileThreads, (tma_min_blocks<T>()))
    apply_slab_tiled_kernel(const __grid_constant__ CUtensorMap xmap,
                            T* __restrict__ y, SlabStencil<T> s, Tiling t) {
  using A = Acc<T>;
  constexpr int K = 2 * P + 1;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  long long pb, npb;
  if (padding_block(s, t, pb, npb)) {  // the grid's last layer: y's padding
    for_each_padding<1>(s, t, pb, npb,
                        [y](const int (&i)[1], int) { y[i[0]] = zero<T>(); });
    return;
  }

  const TileCoords c(s, t);
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

  A cy[K], cz[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    cy[k] = c.active ? widen(__ldg(&s.cvy[k * s.Ly + c.y])) : A(0);
    cz[k] = c.active ? widen(__ldg(&s.cvz[k * s.Lz + c.z])) : A(0);
  }
  const A lyz = c.active ? widen(__ldg(&s.lyz[c.y * s.Lz + c.z])) : A(0);
  A q[K];  // q[k] = x at row gi - 2P + k after plane gi
#pragma unroll
  for (int k = 0; k < K; ++k) q[k] = A(0);
  A yq[P], zq[P];  // ty lxz and tz lxy at row gi - P + 1 + j after plane gi
#pragma unroll
  for (int j = 0; j < P; ++j) yq[j] = zq[j] = A(0);

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
    A ty = A(0), tz = A(0);
    if (c.active && gi >= c.xs && gi < c.xe) {
      ty = cy[P] * q[K - 1];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k != P) ty += cy[k] * widen(ctr[(k - P) * W]);
      }
      tz = cz[P] * q[K - 1];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k != P) tz += cz[k] * widen(ctr[k - P]);
      }
      ty *= widen(__ldg(&s.lxz[(long long)gi * s.Lz + c.z]));
      tz *= widen(__ldg(&s.lxy[(long long)gi * s.Ly + c.y]));
    }
    const A ay = yq[0];
    const A az = zq[0];
#pragma unroll
    for (int j = 0; j < P - 1; ++j) {
      yq[j] = yq[j + 1];
      zq[j] = zq[j + 1];
    }
    yq[P - 1] = ty;
    zq[P - 1] = tz;

    if (i < 2 * P || !c.active) continue;
    const int g = gi - P;  // the output row
    const A tx = x_taps<A, P>(s, q, g);
    y[(long long)g * F + c.f] = narrow<T>((tx * lyz + ay) + az);
  }
}

template <typename T, int P>
int launch_slab(const T* x, T* y, SlabStencil<T> s, Tiling t, dim3 grid,
                int smem, cudaStream_t stream) {
  const TmaWindow w = tma_window<T>(s, t, P);
  if (!tma_fits<T>(s, t, w, x) || smem < tma_smem_bytes<T>(w, 1, 0)) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap xmap;
  const int e = encode_plane_map<T>(&xmap, x, s, w);
  if (e != 0) return e;
  auto kernel = apply_slab_tiled_kernel<T, P>;
  if (smem > 48 * 1024) {
    const cudaError_t r = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (r != cudaSuccess) return (int)r;
  }
  kernel<<<grid, t.ty * t.tz, smem, stream>>>(xmap, y, s, t);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_apply_slab_tiled(const T* x, T* y, SlabStencil<T> s, Tiling t,
                            dim3 grid, int smem, cudaStream_t stream) {
  if (!tma_tiling_fits(t, grid, s.nx, s.ny, s.nz) || !box_fits_int(s) ||
      s.x0 < s.p || s.h < s.p) {
    return (int)cudaErrorInvalidValue;
  }
  switch (s.p) {
    case 1: return launch_slab<T, 1>(x, y, s, t, grid, smem, stream);
    case 2: return launch_slab<T, 2>(x, y, s, t, grid, smem, stream);
    case 3: return launch_slab<T, 3>(x, y, s, t, grid, smem, stream);
    case 4: return launch_slab<T, 4>(x, y, s, t, grid, smem, stream);
    case 5: return launch_slab<T, 5>(x, y, s, t, grid, smem, stream);
    case 6: return launch_slab<T, 6>(x, y, s, t, grid, smem, stream);
    case 7: return launch_slab<T, 7>(x, y, s, t, grid, smem, stream);
    case 8: return launch_slab<T, 8>(x, y, s, t, grid, smem, stream);
    case 9: return launch_slab<T, 9>(x, y, s, t, grid, smem, stream);
    case 10: return launch_slab<T, 10>(x, y, s, t, grid, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace wave

// Plain C interface (bound with ctypes by ops/_cuda.py). The last seven
// ints are ops/rk4step.py::tma_geometry's tiling: ty, tz, cx, the grid
// (gx, gy, gz) and the dynamic shared memory in bytes.
#define WAVE_DEFINE_SLAB_TILED(T, SUFFIX)                                     \
  extern "C" int wave_apply_slab_tiled_##SUFFIX(                              \
      const T* x, T* y, const T* lyz, const T* lxz, const T* lxy,             \
      const T* cvx, const T* cvy, const T* cvz, int p, int Lx, int Ly,        \
      int Lz, int x0, int nx, int h, int ny, int nz, int ty, int tz, int cx,  \
      int gx, int gy, int gz, int smem, cudaStream_t stream) {                \
    wave::SlabStencil<T> s{lyz, lxz, lxy, cvx, cvy, cvz, p,  Lx,              \
                           Ly,  Lz,  x0,  nx,  h,   ny,  nz};                 \
    return wave::launch_apply_slab_tiled<T>(x, y, s, wave::Tiling{ty, tz, cx}, \
                                            dim3(gx, gy, gz), smem, stream);  \
  }

WAVE_DEFINE_SLAB_TILED(float, f32)
WAVE_DEFINE_SLAB_TILED(double, f64)
WAVE_DEFINE_SLAB_TILED(__nv_bfloat16, bf16)
