// Hand-written Hopper kernel of the structured operators (sm_90a); the BP1
// mass (kernel G) is in mass_tiled.cu.
//
// * stiffness_grid_kernel (kernel F) replaces the TPU kernel
//   wave_fenics_tpu/ops/pallas_stiffness.py::_kernel / _kernel_mxu: the
//   separable stiffness y = coeff K x on the unpadded dof grid [Nx, Ny, Nz],
//
//     y = (sum_k cvx[k, i] x[i+k-p, j, l]) ly[j] lz[l]
//       + (sum_k cvy[k, j] x[i, j+k-p, l]) lx[i] lz[l]
//       + (sum_k cvz[k, l] x[i, j, l+k-p]) lx[i] ly[j]
//
//   with coeff and the per-axis face corrections folded into the banded
//   coefficient vectors (ops/stiffness.py::stiffness_grid_tables). A tap
//   outside [0, N) reads zero: that replaces the TPU wrapper's jnp.pad and
//   its (8, 128)-aligned interior offsets, which are TPU layout rules.
//
// What bounds it on this card: 3(2p + 1) multiply-adds a point are far
// below the H100's flop rate; the cost is memory traffic. Kernel F must
// read x and write y once (2 x 67.9 MB in f32 at 64^3 cells, p = 4).
//
// What the design does about it, in this first form: one thread per grid
// point, neighbouring threads on neighbouring z, so each tap row is a
// coalesced load and the 3(2p + 1) taps of a warp hit lines that
// neighbouring warps read too (L1/L2). The line products are formed in
// registers from the three 1D lines.
//
// Each extern "C" launcher returns cudaGetLastError() after its launch (or
// the error of the attribute call before it), so the caller sees a launch
// the runtime refused.

#include <cuda_runtime.h>

namespace wave_ops {

constexpr int kThreads = 256;

inline unsigned num_blocks(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (unsigned)(b < 65535LL * 64 ? b : 65535LL * 64);
}

// ---------------------------------------------------------------------------
// Kernel F: y = coeff K x on the unpadded grid.
// ---------------------------------------------------------------------------

template <typename T>
struct GridStiffness {
  const T* cvx;  // [K, Nx]
  const T* cvy;  // [K, Ny]
  const T* cvz;  // [K, Nz]
  const T* lx;   // [Nx]
  const T* ly;   // [Ny]
  const T* lz;   // [Nz]
  int p, Nx, Ny, Nz;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    stiffness_grid_kernel(const T* __restrict__ x, T* __restrict__ y,
                          GridStiffness<T> s) {
  const int p = s.p;
  const int K = 2 * p + 1;
  const long long sx = (long long)s.Ny * s.Nz;
  const long long n = (long long)s.Nx * sx;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * blockDim.x) {
    const int i = (int)(idx / sx);
    const int r = (int)(idx - (long long)i * sx);
    const int j = r / s.Nz;
    const int l = r - j * s.Nz;
    // per axis, the taps in the TPU kernel's order k = 0..2p
    T tx = T(0);
    for (int k = 0; k < K; ++k) {
      const int ii = i + k - p;
      if (ii >= 0 && ii < s.Nx) tx += s.cvx[k * s.Nx + i] * x[idx + (k - p) * sx];
    }
    T ty = T(0);
    for (int k = 0; k < K; ++k) {
      const int jj = j + k - p;
      if (jj >= 0 && jj < s.Ny) ty += s.cvy[k * s.Ny + j] * x[idx + (k - p) * s.Nz];
    }
    T tz = T(0);
    for (int k = 0; k < K; ++k) {
      const int ll = l + k - p;
      if (ll >= 0 && ll < s.Nz) tz += s.cvz[k * s.Nz + l] * x[idx + (k - p)];
    }
    const T lxi = s.lx[i];
    const T lyj = s.ly[j];
    const T lzl = s.lz[l];
    T out = tx * (lyj * lzl);
    out += ty * (lxi * lzl);
    out += tz * (lxi * lyj);
    y[idx] = out;
  }
}

template <typename T>
int launch_stiffness_grid(const T* x, T* y, GridStiffness<T> s,
                          cudaStream_t stream) {
  const long long n = (long long)s.Nx * s.Ny * s.Nz;
  stiffness_grid_kernel<T><<<num_blocks(n), kThreads, 0, stream>>>(x, y, s);
  return (int)cudaGetLastError();
}

}  // namespace wave_ops

// ---------------------------------------------------------------------------
// Plain C interface (bound with ctypes by ops/_cuda.py).
// ---------------------------------------------------------------------------

#define WAVE_OPS_DEFINE_LAUNCHERS(T, SUFFIX)                                  \
  extern "C" int wave_stiffness_grid_##SUFFIX(                                \
      const T* x, T* y, const T* cvx, const T* cvy, const T* cvz,             \
      const T* lx, const T* ly, const T* lz, int p, int Nx, int Ny, int Nz,   \
      cudaStream_t stream) {                                                  \
    wave_ops::GridStiffness<T> s{cvx, cvy, cvz, lx, ly, lz, p, Nx, Ny, Nz};   \
    return wave_ops::launch_stiffness_grid<T>(x, y, s, stream);               \
  }

WAVE_OPS_DEFINE_LAUNCHERS(float, f32)
WAVE_OPS_DEFINE_LAUNCHERS(double, f64)
