// Kernel F on Hopper (sm_90a): the separable stiffness on the unpadded dof
// grid, on the 2.5D tiled stencil of stencil_tiled.cuh with cp.async plane
// loads.
//
// stiffness_tiled_kernel<T, P> replaces the TPU kernel
// wave_fenics_tpu/ops/pallas_stiffness.py::_kernel / _kernel_mxu: y = coeff
// K x on the grid [Nx, Ny, Nz],
//
//   y = (tx ly[j] lz[l] + ty lx[i] lz[l]) + tz lx[i] ly[j],
//   tx = sum_k cvx[k, i] x[i+k-p, j, l]   (and ty, tz along y and z),
//
// with coeff and the per-axis face corrections folded into the banded
// coefficient vectors (ops/stiffness.py::stiffness_grid_tables). Each sum
// takes its taps in k order and each line product is formed before it
// scales its sum, as the plain version (stiffness_grid_plain) does. A tap
// outside [0, N) reads zero: that replaces the TPU wrapper's jnp.pad and
// its (8, 128)-aligned interior offsets, which are TPU layout rules.
//
// What bounds it on this card: x read once and y written once (2 x 67.9 MB
// in f32 at 64^3 cells, p = 4: 0.0405 ms at 3.35 TB/s); 3(2p + 1)
// multiply-adds a point are far below the flop rate. The earlier per-point
// form loaded all 27 taps of a point from L1/L2 and paid a grid-stride
// loop's div/mod a point: 10.4x that bound.
//
// The design (kernels A and C's, rk4_tiled.cu): the grid is a PaddedBox
// without padding (x0 = h = 0, L = n), so there is no padding layer. A
// block owns a ty x tz tile of (y, z) columns and streams one x-chunk with
// p warm-up planes on each side; a thread owns R rows of one column (two
// in f32 at p <= 4, grid_rows). Each plane of the tile and its p-deep y/z
// halo is copied into a ring of kPipe planes by cp.async, kPipe - 1
// planes ahead, zero-filled outside the grid (cp_async_or_zero): that is
// the zero tap, so no tap loop masks. Element-wise cp.async and not a TMA
// box: a z row of 257 points is 1,028 bytes in f32, and a tensor map's
// row pitch must be a multiple of 16 bytes. The window's pitch in shared
// memory puts a warp's 32 tap loads in 32 banks (grid_pitch). The x taps
// come from a register queue of each row's last 2p + 1 plane values, the
// y and z taps from the plane in shared memory; the rows' cvy, cvz, ly and
// lz sit in registers for the whole chunk, cvx and lx of a plane are one
// broadcast load a warp for all R rows. A plane's two scaled y/z terms
// wait p planes in two register queues until the row's x sum is complete
// (kernel E's, slab_tiled.cu). A first form (one row a thread, four
// blocks an SM, pitch tz + 2p) ran at 0.209 ms at P7, bound by the
// instructions a point issues (PERF.md). P is a template parameter
// (p = 1..10, every degree StructuredOperators takes); the launch bounds
// ask for two 256-thread blocks an SM in f32, one in f64.
//
// The extern "C" launcher returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for a tiling that does not fit the grid, too
// little shared memory, y aliasing x, or a degree outside 1..10.

#include <cuda_runtime.h>

#include "stencil_tiled.cuh"

namespace wave {

// The grid and the tables of kernel F: a PaddedBox with no padding, cvx
// [K, Nx], cvy [K, Ny], cvz [K, Nz] and the lines lx [Nx], ly [Ny],
// lz [Nz] (x_taps reads cvx and Lx).
template <typename T>
struct GridStencil : PaddedBox {
  const T* cvx;
  const T* cvy;
  const T* cvz;
  const T* lx;
  const T* ly;
  const T* lz;

  __host__ __device__ GridStencil(const T* cvx_, const T* cvy_, const T* cvz_,
                                  const T* lx_, const T* ly_, const T* lz_,
                                  int p_, int Nx, int Ny, int Nz)
      : PaddedBox{p_, Nx, Ny, Nz, 0, Nx, 0, Ny, Nz},
        cvx(cvx_), cvy(cvy_), cvz(cvz_), lx(lx_), ly(ly_), lz(lz_) {}
};

// Rows of its tile column one thread owns: two in f32 at p <= 4 (the two
// rows' y taps share their loads from the plane, and the x coefficients,
// the line of the plane and its barrier serve both), else one, so that
// the queues fit the registers. The tile's ty and tz are multiples of it.
template <typename T, int P>
__host__ __device__ constexpr int grid_rows() {
  return sizeof(T) == 4 && P <= 4 ? 2 : 1;
}

// The pitch W of a plane window in shared memory: at least tz + 2P, with
// R W = tz (mod 32). Thread t = ly tz + lz reads the point (R ly + j,
// lz + k) of the window at R ly W + lz + j W + k = t + j W + k (mod 32):
// the 32 lanes of a warp hit 32 distinct banks, so no tap load of a warp
// has a bank conflict.
__host__ __device__ inline int grid_pitch(int tz, int P, int R) {
  const int base = tz / R;
  const int step = 32 / R;
  return base + (tz + 2 * P - base + step - 1) / step * step;
}

// Kernel F's plane window: the (ty + 2P) x (tz + 2P) points around a tile,
// at pitch W in shared memory, and a thread's share of their copies, the
// points e = threadIdx.x + k nt (nt = ty / R * tz threads); tab[e] = {the
// point's offset y Nz + z in a plane, or -1 outside the grid; its index
// in the window}. Each thread writes and reads only its own entries, so
// the table needs no barrier.
template <int P>
struct GridWindow {
  int W, n, nt;
  int2* tab;

  __device__ GridWindow(const PaddedBox& s, const TileCoords& c,
                        const Tiling& t, int R, int2* table)
      : W(grid_pitch(t.tz, P, R)), n((t.ty + 2 * P) * (t.tz + 2 * P)),
        nt(t.ty / R * t.tz), tab(table) {
    const int wc = t.tz + 2 * P;
    for (int e = (int)threadIdx.x; e < n; e += nt) {
      const int r = e / wc;
      const int col = e - r * wc;
      const int yy = c.y0 - P + r;
      const int zz = c.z0 - P + col;
      const bool in = yy >= 0 && yy < s.ny && zz >= 0 && zz < s.nz;
      tab[e] = make_int2(in ? yy * s.Lz + zz : -1, r * W + col);
    }
  }

  // Start the copies of plane g of x into the window dst; points outside
  // the grid become 0 without a load.
  template <typename T>
  __device__ __forceinline__ void fetch(T* dst, const T* x, const PaddedBox& s,
                                        int g) const {
    const bool gx = g >= 0 && g < s.nx;
    const long long row = (long long)g * s.F();
    for (int e = (int)threadIdx.x; e < n; e += nt) {
      const int2 d = tab[e];
      const bool in = gx && d.x >= 0;
      cp_async_or_zero(dst + d.y, x + (in ? row + d.x : 0), in);
    }
  }
};

// Dynamic shared memory of a block: the ring of kPipe windows, then the
// window's copy table.
template <typename T, int P>
inline int grid_smem_bytes(const Tiling& t, int R) {
  const int rows = t.ty + 2 * P;
  return kPipe * rows * grid_pitch(t.tz, P, R) * (int)sizeof(T) +
         rows * (t.tz + 2 * P) * (int)sizeof(int2);
}

// sum_k c[k] v[(k - P) stride], the taps in k order
template <typename T, int P>
__device__ __forceinline__ T axis_taps(const T (&c)[2 * P + 1], const T* v,
                                       int stride) {
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < 2 * P + 1; ++k) acc += c[k] * v[(k - P) * stride];
  return acc;
}

template <typename T, int P>
__global__ void __launch_bounds__(kTileThreads, (tma_min_blocks<T>()))
    stiffness_tiled_kernel(const T* __restrict__ x, T* __restrict__ y,
                           GridStencil<T> s, Tiling t) {
  constexpr int K = 2 * P + 1;
  constexpr int R = grid_rows<T, P>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const TileCoords c(s, t);  // c.ly: the thread's group of R rows
  const int W = grid_pitch(t.tz, P, R);
  const int plane = (t.ty + 2 * P) * W;
  const GridWindow<P> w(s, c, t, R,
                        reinterpret_cast<int2*>(smem + kPipe * plane));
  const int F = s.F();
  const int iters = c.xe - c.xs + 2 * P;  // planes xs - P .. xe + P - 1
#pragma unroll
  for (int i = 0; i < kPipe - 1; ++i) {
    if (i < iters) w.fetch(smem + i * plane, x, s, c.xs - P + i);
    cp_async_commit();
  }

  // the thread's rows y0 + R ly + r of column z: their flat (y, z) index,
  // whether they lie in the grid, their y tables and lines
  int f[R];
  bool act[R];
  T cy[R][K], ly[R];
  const bool zin = c.z < s.nz;
  const T lz = zin ? __ldg(&s.lz[c.z]) : T(0);
  T cz[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    cz[k] = zin ? __ldg(&s.cvz[k * s.Lz + c.z]) : T(0);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int yr = c.y0 + R * c.ly + r;
    f[r] = yr * s.Lz + c.z;
    act[r] = zin && yr < s.ny;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      cy[r][k] = act[r] ? __ldg(&s.cvy[k * s.Ly + yr]) : T(0);
    }
    ly[r] = act[r] ? __ldg(&s.ly[yr]) : T(0);
  }
  T q[R][K];  // q[r][k] = x of row r at plane gi - 2P + k after plane gi
  T yq[R][P], zq[R][P];  // ty lx lz, tz lx ly at plane gi - P + 1 + j
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int k = 0; k < K; ++k) q[r][k] = T(0);
#pragma unroll
    for (int j = 0; j < P; ++j) yq[r][j] = zq[r][j] = T(0);
  }

  for (int i = 0; i < iters; ++i) {
    const int gi = c.xs - P + i;
    const T* buf = smem + (i % kPipe) * plane;
    cp_async_wait<kPipe - 2>();  // this thread's copies of plane gi landed
    __syncthreads();  // plane gi is complete; slot (i - 1) % kPipe is free
    const int ip = i + kPipe - 1;
    if (ip < iters) w.fetch(smem + (ip % kPipe) * plane, x, s, c.xs - P + ip);
    cp_async_commit();

    const T* ctr = buf + (R * c.ly + P) * W + (c.lz + P);  // row 0's point
    T ty[R], tz[R];
    const bool run = gi >= c.xs && gi < c.xe;
    const T lx = run ? __ldg(&s.lx[gi]) : T(0);
    T v[K + R - 1];  // the y taps of the R rows: rows -P .. P + R - 1
#pragma unroll
    for (int j = 0; j < K + R - 1; ++j) {
      v[j] = run || (j >= P && j < P + R) ? ctr[(j - P) * W] : T(0);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int k = 0; k < K - 1; ++k) q[r][k] = q[r][k + 1];
      q[r][K - 1] = v[P + r];
      ty[r] = tz[r] = T(0);
      if (run) {
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < K; ++k) acc += cy[r][k] * v[k + r];
        ty[r] = acc * (lx * lz);
        tz[r] = axis_taps<T, P>(cz, ctr + r * W, 1) * (lx * ly[r]);
      }
    }
    T ay[R], az[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ay[r] = yq[r][0];
      az[r] = zq[r][0];
#pragma unroll
      for (int j = 0; j < P - 1; ++j) {
        yq[r][j] = yq[r][j + 1];
        zq[r][j] = zq[r][j + 1];
      }
      yq[r][P - 1] = ty[r];
      zq[r][P - 1] = tz[r];
    }

    if (i < 2 * P) continue;
    const int g = gi - P;  // the output row
    T tx[R];
#pragma unroll
    for (int r = 0; r < R; ++r) tx[r] = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k) {  // x_taps, one coefficient load for R rows
      const T cxk = __ldg(&s.cvx[k * s.Lx + g]);
#pragma unroll
      for (int r = 0; r < R; ++r) tx[r] += cxk * q[r][k];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (act[r]) {
        y[(long long)g * F + f[r]] = (tx[r] * (ly[r] * lz) + ay[r]) + az[r];
      }
    }
  }
  cp_async_wait<0>();
}

template <typename T, int P>
int launch_grid(const T* x, T* y, GridStencil<T> s, Tiling t, dim3 grid,
                int smem, cudaStream_t stream) {
  // one block per tile (ty rows, R a thread, tz columns) and x-chunk
  constexpr int R = grid_rows<T, P>();
  const auto cdiv = [](int n, int d) { return (n + d - 1) / d; };
  if (t.ty <= 0 || t.tz <= 0 || t.cx <= 0 || t.ty % R != 0 ||
      t.tz % R != 0 || t.ty / R * t.tz > kTileThreads ||
      (int)grid.x != cdiv(s.nz, t.tz) || (int)grid.y != cdiv(s.ny, t.ty) ||
      (int)grid.z != cdiv(s.nx, t.cx) || smem < grid_smem_bytes<T, P>(t, R)) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = stiffness_tiled_kernel<T, P>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, t.ty / R * t.tz, smem, stream>>>(x, y, s, t);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_stiffness_tiled(const T* x, T* y, GridStencil<T> s, Tiling t,
                           dim3 grid, int smem, cudaStream_t stream) {
  if (x == y) return (int)cudaErrorInvalidValue;
  switch (s.p) {
    case 1: return launch_grid<T, 1>(x, y, s, t, grid, smem, stream);
    case 2: return launch_grid<T, 2>(x, y, s, t, grid, smem, stream);
    case 3: return launch_grid<T, 3>(x, y, s, t, grid, smem, stream);
    case 4: return launch_grid<T, 4>(x, y, s, t, grid, smem, stream);
    case 5: return launch_grid<T, 5>(x, y, s, t, grid, smem, stream);
    case 6: return launch_grid<T, 6>(x, y, s, t, grid, smem, stream);
    case 7: return launch_grid<T, 7>(x, y, s, t, grid, smem, stream);
    case 8: return launch_grid<T, 8>(x, y, s, t, grid, smem, stream);
    case 9: return launch_grid<T, 9>(x, y, s, t, grid, smem, stream);
    case 10: return launch_grid<T, 10>(x, y, s, t, grid, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace wave

// Plain C interface (bound with ctypes by ops/_cuda.py). The last seven
// ints are ops/tiling.py::grid_geometry's tiling: ty, tz, cx, the grid
// (gx, gy, gz) and the dynamic shared memory in bytes.
#define WAVE_DEFINE_STIFFNESS_TILED(T, SUFFIX)                                \
  extern "C" int wave_stiffness_tiled_##SUFFIX(                               \
      const T* x, T* y, const T* cvx, const T* cvy, const T* cvz,             \
      const T* lx, const T* ly, const T* lz, int p, int Nx, int Ny, int Nz,   \
      int ty, int tz, int cx, int gx, int gy, int gz, int smem,               \
      cudaStream_t stream) {                                                  \
    wave::GridStencil<T> s{cvx, cvy, cvz, lx, ly, lz, p, Nx, Ny, Nz};         \
    return wave::launch_stiffness_tiled<T>(x, y, s, wave::Tiling{ty, tz, cx}, \
                                           dim3(gx, gy, gz), smem, stream);   \
  }

WAVE_DEFINE_STIFFNESS_TILED(float, f32)
WAVE_DEFINE_STIFFNESS_TILED(double, f64)
