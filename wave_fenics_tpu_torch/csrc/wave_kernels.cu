// Hand-written Hopper kernels of the planar3d RK4 path (sm_90a).
//
// Two entry points share the stencil of stencil.cuh:
//
// * apply_flat_kernel (kernel B) replaces the TPU kernel
//   wave_fenics_tpu/ops/pallas_wave.py::_kernel_flat: y = A x on the flat
//   padded layout.
// * rk4_stage_kernel<J> (kernel A) replaces
//   wave_fenics_tpu/ops/pallas_rk4step.py::_kernel_rk4_step_lean: one
//   classic RK4 step as four launches, one per stage J = 0..3, with the
//   collapsed (lean) stage algebra of that kernel.
//
// What bounds them on this card: a stencil of 3 * (2p + 1) taps per point
// with one multiply-add per tap is far below the H100's flop rate, so the
// cost is memory traffic. Each point reads its 27 taps (p = 4) from L1/L2,
// and each stage streams its inputs and output through HBM once: a state
// field at the headline size is 31.9 MB in f32 and the five fields of a
// step (u0, v0, kv0..kv2) do not fit the 50 MB L2 together.
//
// What the design does about it, in this first form: one thread per
// padded point, neighbouring threads on neighbouring f, so every tap row
// is a coalesced load and the x taps of a warp hit the same L2 lines that
// the neighbouring blocks read; the stage inputs (un_J) are formed at each
// tap from the fields in memory instead of being written out; padding
// points write zeros without reading anything. The TPU kernel's one-pass
// halo recompute is not carried over: one padded row of F is 83 KB in f32,
// so an (x-tile + 6p halo) x F slab does not fit the 227 KB of shared
// memory. Fusing the four stages into one pass over 3D bricks is the first
// performance step (ROADMAP.md).
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
// Kernel A: one RK4 stage. With kv_J = A un_J + face terms and
//
//   un0 = u0                      vn0 = v0
//   un1 = u0 + dt/2 v0            vn1 = v0 + dt/2 kv0
//   un2 = un1 + dt^2/4 kv0        vn2 = v0 + dt/2 kv1
//   un3 = (u0 + dt v0) + dt^2/2 kv1   vn3 = v0 + dt kv2
//
// stages 0..2 write kv_J; stage 3 writes
//   u1 = (u0 + dt v0) + dt^2/6 (kv0 + kv1 + kv2)
//   v1 = v0 + dt/6 (kv0 + 2 kv1 + 2 kv2 + kv3).
// The face terms act on rows src_x and abc_x only, in the TPU kernel's
// order: the stencil, then the source c0^2 g_J W1, then the absorbing
// term -c0 W2 vn_J.
// ---------------------------------------------------------------------------

template <typename T>
struct StageArgs {
  const T* u0;
  const T* v0;
  const T* kv0;
  const T* kv1;
  const T* kv2;
  T* kv_out;  // stages 0..2
  T* u1;      // stage 3
  T* v1;      // stage 3
  const T* w1;  // [F] source facet weights / m
  const T* w2;  // [F] absorbing facet weights / m
  int src_x, abc_x;
  T dt, g, c0sq, mc0;
};

template <typename T, int J>
__global__ void __launch_bounds__(kThreads)
    rk4_stage_kernel(Stencil<T> s, StageArgs<T> a) {
  const int F = s.F();
  const long long n = (long long)s.Lx * F;
  const T dt = a.dt;
  const T dt2 = dt * dt;
  const T half = T(0.5);

  auto load = [&a, F, dt, dt2, half](int g, int f) -> T {
    const long long j = (long long)g * F + f;
    if constexpr (J == 0) {
      return a.u0[j];
    } else if constexpr (J == 1) {
      return a.u0[j] + (half * dt) * a.v0[j];
    } else if constexpr (J == 2) {
      return (a.u0[j] + (half * dt) * a.v0[j]) + (T(0.25) * dt2) * a.kv0[j];
    } else {
      return (a.u0[j] + dt * a.v0[j]) + (half * dt2) * a.kv1[j];
    }
  };

  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int g = (int)(i / F);
    const int f = (int)(i - (long long)g * F);
    if (!s.interior(g, f)) {
      if constexpr (J < 3) {
        a.kv_out[i] = T(0);
      } else {
        a.u1[i] = T(0);
        a.v1[i] = T(0);
      }
      continue;
    }
    T kv = apply_stencil(s, load, g, f);
    if (g == a.src_x) kv += (a.c0sq * a.g) * a.w1[f];
    if (g == a.abc_x) {
      T vn;
      if constexpr (J == 0) {
        vn = a.v0[i];
      } else if constexpr (J == 1) {
        vn = a.v0[i] + (half * dt) * a.kv0[i];
      } else if constexpr (J == 2) {
        vn = a.v0[i] + (half * dt) * a.kv1[i];
      } else {
        vn = a.v0[i] + dt * a.kv2[i];
      }
      kv += (a.mc0 * a.w2[f]) * vn;
    }
    if constexpr (J < 3) {
      a.kv_out[i] = kv;
    } else {
      const T k1 = a.kv1[i];
      const T k2 = a.kv2[i];
      const T s2 = (a.kv0[i] + k1) + k2;
      a.u1[i] = (a.u0[i] + dt * a.v0[i]) + (dt2 / T(6)) * s2;
      a.v1[i] = a.v0[i] + (dt / T(6)) * (((s2 + k1) + k2) + kv);
    }
  }
}

template <typename T>
Stencil<T> make_stencil(const T* cvx, const T* sx, const T* fx, const T* cvy,
                        const T* cvz, int p, int Lx, int Ly, int Lz, int x0,
                        int nx, int h, int ny, int nz) {
  return Stencil<T>{cvx, sx, fx, cvy, cvz, p, Lx, Ly, Lz, x0, nx, h, ny, nz};
}

template <typename T>
int launch_apply_flat(const T* x, T* y, Stencil<T> s, cudaStream_t stream) {
  const long long n = (long long)s.Lx * s.Ly * s.Lz;
  apply_flat_kernel<T><<<num_blocks(n), kThreads, 0, stream>>>(x, y, s);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rk4_stage(int stage, Stencil<T> s, StageArgs<T> a,
                     cudaStream_t stream) {
  const long long n = (long long)s.Lx * s.Ly * s.Lz;
  const unsigned nb = num_blocks(n);
  switch (stage) {
    case 0: rk4_stage_kernel<T, 0><<<nb, kThreads, 0, stream>>>(s, a); break;
    case 1: rk4_stage_kernel<T, 1><<<nb, kThreads, 0, stream>>>(s, a); break;
    case 2: rk4_stage_kernel<T, 2><<<nb, kThreads, 0, stream>>>(s, a); break;
    case 3: rk4_stage_kernel<T, 3><<<nb, kThreads, 0, stream>>>(s, a); break;
    default: return (int)cudaErrorInvalidValue;
  }
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
  extern "C" int wave_rk4_stage_##SUFFIX(                                     \
      int stage, const T* u0, const T* v0, const T* kv0, const T* kv1,        \
      const T* kv2, T* kv_out, T* u1, T* v1, const T* w1, const T* w2,        \
      int src_x, int abc_x, double dt, double g, double c0,                   \
      WAVE_STENCIL_PARAMS(T), cudaStream_t stream) {                          \
    wave::StageArgs<T> a{u0, v0, kv0, kv1, kv2, kv_out, u1, v1, w1, w2,       \
                         src_x, abc_x, (T)dt, (T)g, (T)(c0 * c0), (T)(-c0)};  \
    return wave::launch_rk4_stage<T>(                                         \
        stage, wave::make_stencil<T>(WAVE_STENCIL_ARGS), a, stream);          \
  }

WAVE_DEFINE_LAUNCHERS(float, f32)
WAVE_DEFINE_LAUNCHERS(double, f64)

extern "C" const char* wave_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
