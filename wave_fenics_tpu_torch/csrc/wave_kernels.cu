// Hand-written Hopper kernel of the planar3d solver paths on the flat
// padded layout (sm_90a), on the stencil of stencil.cuh (kernels A and C,
// the RK4 step, are in rk4_tiled.cu, kernel D, the fused RK4 stage, in
// rk_stage_tiled.cu, kernels H and I, the leapfrog phases, in lf_tiled.cu,
// and kernel J's step boundary in rk42_tiled.cu, on the tiled stencil of
// stencil_tiled.cuh):
//
// * apply_flat_kernel (kernel B) replaces the TPU kernel
//   wave_fenics_tpu/ops/pallas_wave.py::_kernel_flat: y = A x on the flat
//   padded layout.
//
// What bounds it on this card: a stencil of 3 * (2p + 1) taps per point
// with one multiply-add per tap is far below the H100's flop rate, so the
// cost is memory traffic: x's interior read once (its padding is 0) and
// the padded y written once, 17.1 + 31.9 MB in f32 at the headline size. Each point reads its taps (27 at p = 4, 51 at p = 8)
// from L1/L2.
//
// What the design does about it, in this first form: one thread per
// padded point, neighbouring threads on neighbouring f, so every tap row
// is a coalesced load and the x taps of a warp hit the same L2 lines that
// the neighbouring blocks read; padding points write zeros without reading
// any tap. Moving it onto the tiled stencil of stencil_tiled.cuh, as
// kernels A, C, D, G, H, I and J's boundary did, is the next performance
// step (ROADMAP.md).
//
// The extern "C" launcher returns cudaGetLastError() after its launch, so
// the caller sees a launch the runtime refused.

#include <cuda_runtime.h>

#include "stencil.cuh"

namespace wave {

constexpr int kThreads = 256;

inline unsigned num_blocks(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (unsigned)(b < 65535LL * 64 ? b : 65535LL * 64);
}

// ---------------------------------------------------------------------------
// Kernel B: y = A x.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    apply_flat_kernel(const T* __restrict__ x, T* __restrict__ y,
                      Stencil<T> s) {
  const int F = s.F();
  const long long n = (long long)s.Lx * F;
  auto load = [x, F](int g, int f) { return x[(long long)g * F + f]; };
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int g = (int)(i / F);
    const int f = (int)(i - (long long)g * F);
    y[i] = s.interior(g, f) ? apply_stencil(s, load, g, f) : T(0);
  }
}

template <typename T>
Stencil<T> make_stencil(const T* cvx, const T* sx, const T* fx, const T* cvy,
                        const T* cvz, int p, int Lx, int Ly, int Lz, int x0,
                        int nx, int h, int ny, int nz) {
  return Stencil<T>{cvx, sx, fx, cvy, cvz, p, Lx, Ly, Lz, x0, nx, h, ny, nz};
}

template <typename T>
unsigned blocks_of(const Stencil<T>& s) {
  return num_blocks((long long)s.Lx * s.Ly * s.Lz);
}

template <typename T>
int launch_apply_flat(const T* x, T* y, Stencil<T> s, cudaStream_t stream) {
  apply_flat_kernel<T><<<blocks_of(s), kThreads, 0, stream>>>(x, y, s);
  return (int)cudaGetLastError();
}

}  // namespace wave

// ---------------------------------------------------------------------------
// Plain C interface (bound with ctypes by ops/_cuda.py).
// ---------------------------------------------------------------------------

#define WAVE_STENCIL_PARAMS(T)                                              \
  const T *cvx, const T *sx, const T *fx, const T *cvy, const T *cvz, int p, \
      int Lx, int Ly, int Lz, int x0, int nx, int h, int ny, int nz
#define WAVE_STENCIL_ARGS cvx, sx, fx, cvy, cvz, p, Lx, Ly, Lz, x0, nx, h, ny, nz

#define WAVE_DEFINE_LAUNCHERS(T, SUFFIX)                                      \
  extern "C" int wave_apply_flat_##SUFFIX(const T* x, T* y,                   \
                                          WAVE_STENCIL_PARAMS(T),             \
                                          cudaStream_t stream) {              \
    return wave::launch_apply_flat<T>(                                        \
        x, y, wave::make_stencil<T>(WAVE_STENCIL_ARGS), stream);              \
  }

WAVE_DEFINE_LAUNCHERS(float, f32)
WAVE_DEFINE_LAUNCHERS(double, f64)

extern "C" const char* wave_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
