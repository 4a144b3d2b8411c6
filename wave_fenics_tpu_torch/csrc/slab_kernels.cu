// Hand-written Hopper kernel E of the 3D-slab layout (sm_90a).
//
// apply_slab_kernel replaces the TPU kernel
// wave_fenics_tpu/ops/pallas_wave.py::_kernel: y = A x = -c0^2 (K x)/m on
// the padded [Lx, Ly, Lz] state with z aligned to 128, the layout the JAX
// package takes for p > 8 (the flat layout's 8-deep halo window holds
// p <= 8) or kernel='3d'. The stencil is stencil.cuh::apply_slab_stencil:
// 3 (2p + 1) taps per point, 63 at p = 10.
//
// What bounds it on this card: one multiply-add per tap is far below the
// flop rate, so the compulsory cost is memory: the interior of x read once
// and the whole padded y written once (at p = 10, cells 26x13x13: 17.9 MB
// in and 47.3 MB out in f32, about 0.02 ms at 3.35 TB/s). The taps
// themselves are loads from L1/L2: each point reads 63 values of x.
//
// What this first form does about it: one thread per padded point,
// neighbouring threads on neighbouring z, so each tap row of a warp is one
// coalesced load and the x and y taps of neighbouring warps hit the same
// L2 lines; a point outside the interior writes 0 without reading a tap,
// so every padded cell of y is exactly 0, as the TPU kernel's zero lines
// and all-pad tiles make it. The TPU kernel's double-buffered x-slab DMA
// has no counterpart: the caches serve the halo. Tiling x-y-z bricks
// through shared memory is later work.
//
// The extern "C" launcher returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include "stencil.cuh"

namespace wave {

constexpr int kSlabThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kSlabThreads)
    apply_slab_kernel(const T* __restrict__ x, T* __restrict__ y,
                      SlabStencil<T> s) {
  const long long plane = (long long)s.Ly * s.Lz;
  const long long n = (long long)s.Lx * plane;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int gx = (int)(i / plane);
    const int r = (int)(i - gx * plane);
    const int gy = r / s.Lz;
    const int gz = r - gy * s.Lz;
    y[i] = s.interior(gx, gy, gz) ? apply_slab_stencil(s, x, gx, gy, gz) : T(0);
  }
}

template <typename T>
int launch_apply_slab(const T* x, T* y, SlabStencil<T> s, cudaStream_t stream) {
  const long long n = (long long)s.Lx * s.Ly * s.Lz;
  long long blocks = (n + kSlabThreads - 1) / kSlabThreads;
  if (blocks > 65535LL * 64) blocks = 65535LL * 64;
  apply_slab_kernel<T><<<(unsigned)blocks, kSlabThreads, 0, stream>>>(x, y, s);
  return (int)cudaGetLastError();
}

}  // namespace wave

// Plain C interface (bound with ctypes by ops/_cuda.py).
#define WAVE_DEFINE_SLAB(T, SUFFIX)                                            \
  extern "C" int wave_apply_slab_##SUFFIX(                                     \
      const T* x, T* y, const T* lyz, const T* lxz, const T* lxy,              \
      const T* cvx, const T* cvy, const T* cvz, int p, int Lx, int Ly, int Lz, \
      int x0, int nx, int h, int ny, int nz, cudaStream_t stream) {            \
    wave::SlabStencil<T> s{lyz, lxz, lxy, cvx, cvy, cvz, p,  Lx,                \
                           Ly,  Lz,  x0,  nx,  h,   ny,  nz};                  \
    return wave::launch_apply_slab<T>(x, y, s, stream);                        \
  }

WAVE_DEFINE_SLAB(float, f32)
WAVE_DEFINE_SLAB(double, f64)
