// Hand-written Hopper kernels of the structured operators (sm_90a).
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
// * mass_apply_kernel (kernel G) replaces
//   wave_fenics_tpu/ops/pallas_mass.py::_kernel_mass: the consistent Gauss
//   mass of CEED BP1, y = (Mx (x) My (x) Mz) x, as three banded 1D
//   contractions (x, then y, then z, the TPU kernel's order) on the padded
//   layout [Lx, Ly, Lz] (ops/mass.py). The coefficient vectors are zero
//   outside the interior, so the padding of y is exactly zero.
//
// What bounds them on this card: (2p + 1) multiply-adds per tap axis and
// point are far below the H100's flop rate; the cost is memory traffic.
// Kernel F must read x and write y once (2 x 67.9 MB in f32 at 64^3 cells,
// p = 4); kernel G the same on the padded state (2 x 90.0 MB).
//
// What the designs do about it, in this first form:
//
// * F: one thread per grid point, neighbouring threads on neighbouring z,
//   so each tap row is a coalesced load and the 3(2p + 1) taps of a warp
//   hit lines that neighbouring warps read too (L1/L2). The line products
//   are formed in registers from the three 1D lines.
// * G: one launch per matvec. A block owns an output brick of
//   kBX x kBY x kBZ points. It contracts x while it streams the input
//   columns of the brick and its p-deep y/z halo from global memory (each
//   column's kBX + 2p rows read once, into kBX register accumulators) and
//   keeps t1 = Mx x, with the y/z halo, in shared memory; then the y
//   contraction into t2 (z halo kept), then the z contraction, which
//   writes the brick once. Bricks with no interior point write zeros and
//   read nothing. Shared memory: (kBX (kBY + 2p)(kBZ + 2p) +
//   kBX kBY (kBZ + 2p) + (2p + 1)(kBX + kBY + kBZ)) elements, 32 KB at
//   p = 4 in f32, 105 KB at p = 8 in f64 (above 48 KB it is opted into with
//   cudaFuncSetAttribute). The halo is re-read by neighbouring bricks from
//   L2, not from HBM.
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

// ---------------------------------------------------------------------------
// Kernel G: y = (Mx (x) My (x) Mz) x on the padded layout.
// ---------------------------------------------------------------------------

constexpr int kBX = 8;   // brick extent in x (register accumulators/thread)
constexpr int kBY = 8;   // ... in y
constexpr int kBZ = 32;  // ... in z (a warp's row: coalesced loads/stores)

struct MassShape {
  int p, Lx, Ly, Lz;
  int x0, nx, h, ny, nz;  // interior box: [x0, x0+nx) x [h, h+ny) x [h, h+nz)
};

template <typename T>
size_t mass_smem_bytes(int p) {
  const int WY = kBY + 2 * p;
  const int WZ = kBZ + 2 * p;
  const int K = 2 * p + 1;
  return sizeof(T) * (size_t)(kBX * WY * WZ + kBX * kBY * WZ +
                              K * (kBX + kBY + kBZ));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mass_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                      const T* __restrict__ cvx, const T* __restrict__ cvy,
                      const T* __restrict__ cvz, MassShape s) {
  extern __shared__ unsigned char smem_raw[];
  const int p = s.p;
  const int K = 2 * p + 1;
  const int WY = kBY + 2 * p;
  const int WZ = kBZ + 2 * p;
  T* t1 = reinterpret_cast<T*>(smem_raw);  // [kBX][WY][WZ]
  T* t2 = t1 + kBX * WY * WZ;              // [kBX][kBY][WZ]
  T* cx = t2 + kBX * kBY * WZ;             // [K][kBX]
  T* cy = cx + K * kBX;                    // [K][kBY]
  T* cz = cy + K * kBY;                    // [K][kBZ]
  const int gx0 = blockIdx.z * kBX;
  const int gy0 = blockIdx.y * kBY;
  const int gz0 = blockIdx.x * kBZ;
  const int tid = threadIdx.x;
  const long long plane = (long long)s.Ly * s.Lz;

  auto store = [&](int i, int j, int l, T v) {
    const int gx = gx0 + i, gy = gy0 + j, gz = gz0 + l;
    if (gx < s.Lx && gy < s.Ly && gz < s.Lz) y[gx * plane + (long long)gy * s.Lz + gz] = v;
  };

  if (gx0 + kBX <= s.x0 || gx0 >= s.x0 + s.nx || gy0 + kBY <= s.h ||
      gy0 >= s.h + s.ny || gz0 + kBZ <= s.h || gz0 >= s.h + s.nz) {
    for (int e = tid; e < kBX * kBY * kBZ; e += blockDim.x) {
      const int i = e / (kBY * kBZ);
      const int r = e - i * (kBY * kBZ);
      store(i, r / kBZ, r % kBZ, T(0));
    }
    return;
  }

  for (int e = tid; e < K * kBX; e += blockDim.x) {
    const int g = gx0 + e % kBX;
    cx[e] = g < s.Lx ? cvx[(e / kBX) * s.Lx + g] : T(0);
  }
  for (int e = tid; e < K * kBY; e += blockDim.x) {
    const int g = gy0 + e % kBY;
    cy[e] = g < s.Ly ? cvy[(e / kBY) * s.Ly + g] : T(0);
  }
  for (int e = tid; e < K * kBZ; e += blockDim.x) {
    const int g = gz0 + e % kBZ;
    cz[e] = g < s.Lz ? cvz[(e / kBZ) * s.Lz + g] : T(0);
  }
  __syncthreads();

  // 1. x: t1[i][jj][ll] = sum_k cx[k][i] x[gx0 + i + k - p, gy0 + jj - p,
  //    gz0 + ll - p]; each input column read once, row by row
  for (int c = tid; c < WY * WZ; c += blockDim.x) {
    const int jj = c / WZ;
    const int ll = c - jj * WZ;
    const int gy = gy0 + jj - p;
    const int gz = gz0 + ll - p;
    T acc[kBX];
#pragma unroll
    for (int i = 0; i < kBX; ++i) acc[i] = T(0);
    if (gy >= 0 && gy < s.Ly && gz >= 0 && gz < s.Lz) {
      const T* col = x + (long long)gy * s.Lz + gz;
      for (int r = 0; r < kBX + 2 * p; ++r) {
        const int gx = gx0 + r - p;
        const T xv = (gx >= 0 && gx < s.Lx) ? col[gx * plane] : T(0);
#pragma unroll
        for (int i = 0; i < kBX; ++i) {
          const int k = r - i;
          if (k >= 0 && k < K) acc[i] += cx[k * kBX + i] * xv;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kBX; ++i) t1[(i * WY + jj) * WZ + ll] = acc[i];
  }
  __syncthreads();

  // 2. y: t2[i][j][ll] = sum_k cy[k][j] t1[i][j + k][ll], shift 0 first
  for (int e = tid; e < kBX * kBY * WZ; e += blockDim.x) {
    const int i = e / (kBY * WZ);
    const int r = e - i * (kBY * WZ);
    const int j = r / WZ;
    const int ll = r - j * WZ;
    const T* col = t1 + (i * WY + j) * WZ + ll;
    T acc = cy[p * kBY + j] * col[p * WZ];
    for (int k = 0; k < K; ++k) {
      if (k != p) acc += cy[k * kBY + j] * col[k * WZ];
    }
    t2[e] = acc;
  }
  __syncthreads();

  // 3. z: y[i][j][l] = sum_k cz[k][l] t2[i][j][l + k], shift 0 first
  for (int e = tid; e < kBX * kBY * kBZ; e += blockDim.x) {
    const int i = e / (kBY * kBZ);
    const int r = e - i * (kBY * kBZ);
    const int j = r / kBZ;
    const int l = r - j * kBZ;
    const T* row = t2 + (i * kBY + j) * WZ + l;
    T acc = cz[p * kBZ + l] * row[p];
    for (int k = 0; k < K; ++k) {
      if (k != p) acc += cz[k * kBZ + l] * row[k];
    }
    store(i, j, l, acc);
  }
}

template <typename T>
int launch_stiffness_grid(const T* x, T* y, GridStiffness<T> s,
                          cudaStream_t stream) {
  const long long n = (long long)s.Nx * s.Ny * s.Nz;
  stiffness_grid_kernel<T><<<num_blocks(n), kThreads, 0, stream>>>(x, y, s);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_mass_apply(const T* x, T* y, const T* cvx, const T* cvy,
                      const T* cvz, MassShape s, cudaStream_t stream) {
  const size_t smem = mass_smem_bytes<T>(s.p);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mass_apply_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((s.Lz + kBZ - 1) / kBZ, (s.Ly + kBY - 1) / kBY,
                  (s.Lx + kBX - 1) / kBX);
  mass_apply_kernel<T><<<grid, kThreads, smem, stream>>>(x, y, cvx, cvy, cvz, s);
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
  }                                                                           \
  extern "C" int wave_mass_apply_##SUFFIX(                                    \
      const T* x, T* y, const T* cvx, const T* cvy, const T* cvz, int p,      \
      int Lx, int Ly, int Lz, int x0, int nx, int h, int ny, int nz,          \
      cudaStream_t stream) {                                                  \
    wave_ops::MassShape s{p, Lx, Ly, Lz, x0, nx, h, ny, nz};                  \
    return wave_ops::launch_mass_apply<T>(x, y, cvx, cvy, cvz, s, stream);    \
  }

WAVE_OPS_DEFINE_LAUNCHERS(float, f32)
WAVE_OPS_DEFINE_LAUNCHERS(double, f64)
