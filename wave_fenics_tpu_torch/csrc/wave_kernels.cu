// Hand-written Hopper kernels of the planar3d solver paths (sm_90a).
//
// Two entry points share the stencil of stencil.cuh (kernels A and C, the
// RK4 step, are in rk4_tiled.cu, kernel D, the fused RK4 stage, in
// rk_stage_tiled.cu, and kernels H and I, the leapfrog phases, in
// lf_tiled.cu, on the tiled stencil of stencil_tiled.cuh):
//
// * apply_flat_kernel (kernel B) replaces the TPU kernel
//   wave_fenics_tpu/ops/pallas_wave.py::_kernel_flat: y = A x on the flat
//   padded layout.
// * rk42_boundary_kernel with six kernel-C stages (kernel J) replaces
//   pallas_rk42step.py::_kernel_rk42_step: two full-tableau RK4 steps in
//   seven launches, the step boundary (step 1's stage 3 and step 2's stage
//   0) fused into one. The TPU kernel's 6p wedge and its six shrinking
//   stage windows keep a slab in VMEM; a launch here covers the whole grid,
//   so they have no counterpart.
//
// What bounds them on this card: a stencil of 3 * (2p + 1) taps per point
// with one multiply-add per tap is far below the H100's flop rate, so the
// cost is memory traffic. Each point reads its taps (27 at p = 4, 51 at
// p = 8) from L1/L2, and each launch streams its inputs and outputs through
// HBM once: a state field at the headline size is 31.9 MB in f32, and the
// fields of a step do not fit the 50 MB L2 together.
//
// What the design does about it, in this first form: one thread per
// padded point, neighbouring threads on neighbouring f, so every tap row
// is a coalesced load and the x taps of a warp hit the same L2 lines that
// the neighbouring blocks read; a stage input (un3 or u1) is formed at
// each tap from the fields in memory instead of being written out; padding
// points write zeros without reading any tap. Moving them onto the tiled
// stencil of stencil_tiled.cuh, as kernels A, C, D, H and I did, is the
// next performance step (ROADMAP.md).
//
// Each extern "C" launcher returns cudaGetLastError() after its launch, so
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

// ---------------------------------------------------------------------------
// Kernel J: two full-tableau RK4 steps in seven launches instead of kernel
// C's eight. Stages 0..2 of step 1 and stages 1..3 of step 2 are kernel C's
// stages (rk4_tiled.cu, lean = 0); the step boundary is one launch of
// rk42_boundary_kernel, which at each point computes, with a = dt/2 and
// g = g(t + dt) (the time of step 1's stage 3 and of step 2's stage 0),
//
//   kv3  = A un3 + c0^2 g W1 - c0 W2 vn3,    un3 = u0 + dt (v0 + a kv1)
//   u1   = u0 + dt (((b0 v0 + b1 vn1) + b2 vn2) + b3 vn3)
//   v1   = v0 + dt (((b0 kv0 + b1 kv1) + b2 kv2) + b3 kv3)
//   kv0' = A u1 + c0^2 g W1 - c0 W2 v1       (step 2's stage 0)
//
// u1 does not depend on kv3, so A u1 forms u1 at each of its taps from
// (u0, v0, kv0, kv1, kv2) with the expression stage 3 of kernel C writes;
// only v1, read at the point itself, needs kv3. u1, v1 and kv0' are
// written for step 2's stages; none of them may alias an input.
// ---------------------------------------------------------------------------

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
  T dt, g, c0sq, mc0;
};

template <typename T>
__device__ __forceinline__ T full_tableau_u1(const BoundaryArgs<T>& a,
                                             long long j, T dt) {
  const T half = T(0.5);
  const T b0 = T(1.0 / 6.0);
  const T b1 = T(1.0 / 3.0);
  const T v0 = a.v0[j];
  const T vn1 = v0 + (half * dt) * a.kv0[j];
  const T vn2 = v0 + (half * dt) * a.kv1[j];
  const T vn3 = v0 + dt * a.kv2[j];
  return a.u0[j] + dt * (((b0 * v0 + b1 * vn1) + b1 * vn2) + b0 * vn3);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rk42_boundary_kernel(Stencil<T> s, BoundaryArgs<T> a) {
  const int F = s.F();
  const long long n = (long long)s.Lx * F;
  const T dt = a.dt;
  const T half = T(0.5);
  const T b0 = T(1.0 / 6.0);
  const T b1 = T(1.0 / 3.0);
  auto un3 = [&a, F, dt, half](int g, int f) -> T {
    const long long j = (long long)g * F + f;
    return a.u0[j] + dt * (a.v0[j] + (half * dt) * a.kv1[j]);
  };
  auto u1 = [&a, F, dt](int g, int f) -> T {
    return full_tableau_u1(a, (long long)g * F + f, dt);
  };
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int g = (int)(i / F);
    const int f = (int)(i - (long long)g * F);
    if (!s.interior(g, f)) {
      a.u1[i] = T(0);
      a.v1[i] = T(0);
      a.kv0_out[i] = T(0);
      continue;
    }
    const T v0 = a.v0[i];
    const T k2 = a.kv2[i];
    T kv3 = apply_stencil(s, un3, g, f);
    if (g == a.src_x) kv3 += (a.c0sq * a.g) * a.w1[f];
    if (g == a.abc_x) kv3 += (a.mc0 * a.w2[f]) * (v0 + dt * k2);
    const T accv = ((b0 * a.kv0[i] + b1 * a.kv1[i]) + b1 * k2) + b0 * kv3;
    const T v1 = v0 + dt * accv;
    T kv = apply_stencil(s, u1, g, f);
    if (g == a.src_x) kv += (a.c0sq * a.g) * a.w1[f];
    if (g == a.abc_x) kv += (a.mc0 * a.w2[f]) * v1;
    a.u1[i] = u1(g, f);
    a.v1[i] = v1;
    a.kv0_out[i] = kv;
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

template <typename T>
int launch_rk42_boundary(Stencil<T> s, BoundaryArgs<T> a, cudaStream_t stream) {
  rk42_boundary_kernel<T><<<blocks_of(s), kThreads, 0, stream>>>(s, a);
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
  }                                                                           \
  extern "C" int wave_rk42_boundary_##SUFFIX(                                 \
      const T* u0, const T* v0, const T* kv0, const T* kv1, const T* kv2,     \
      T* u1, T* v1, T* kv0_out, const T* w1, const T* w2, int src_x,          \
      int abc_x, double dt, double g, double c0, WAVE_STENCIL_PARAMS(T),      \
      cudaStream_t stream) {                                                  \
    wave::BoundaryArgs<T> a{u0, v0, kv0, kv1, kv2, u1, v1, kv0_out, w1, w2,  \
                            src_x, abc_x, (T)dt, (T)g, (T)(c0 * c0),          \
                            (T)(-c0)};                                        \
    return wave::launch_rk42_boundary<T>(                                     \
        wave::make_stencil<T>(WAVE_STENCIL_ARGS), a, stream);                 \
  }

WAVE_DEFINE_LAUNCHERS(float, f32)
WAVE_DEFINE_LAUNCHERS(double, f64)

extern "C" const char* wave_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
