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
// bf16 state: x, y and the tables bf16, the sums in float32, y rounded
// once; the window is copied in 4-byte pairs (GridWindow); f32's rows a
// thread and launch bounds.
//
// The extern "C" launcher returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for a tiling that does not fit the grid, too
// little shared memory, y aliasing x, a bf16 x that is not 4-byte aligned,
// or a degree outside 1..10.

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

// Rows of its tile column one thread owns: two in f32 and bf16 at p <= 4
// (the two rows' y taps share their loads from the plane, and the x
// coefficients, the line of the plane and its barrier serve both), else
// one, so that the queues fit the registers. The tile's ty and tz are
// multiples of it. (bf16 on f64's one row and one block an SM took 0.38
// ms/apply at 64^3 cells, p = 4; on f32's rules 0.35; PERF.md section 6.)
template <typename T, int P>
__host__ __device__ constexpr int grid_rows() {
  return sizeof(T) <= 4 && P <= 4 ? 2 : 1;
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

// The window's pitch for T: grid_pitch, and for bf16 (copied in pairs) one
// more where its parity is not Nz's (GridWindow).
template <typename T>
__host__ __device__ inline int window_pitch(int tz, int P, int R, int Nz) {
  const int W = grid_pitch(tz, P, R);
  return copy_width<T>() == 2 ? W + ((W - Nz) & 1) : W;
}

// Elements of one plane's slot in the ring: the window, and for bf16 room
// for the slot's shift (GridWindow::shift), kept even.
template <typename T>
__host__ __device__ inline int window_slot(int rows, int W) {
  return copy_width<T>() == 2 ? (rows * W + 2) & ~1 : rows * W;
}

// Kernel F's plane window: the (ty + 2P) x (tz + 2P) points around a tile,
// at pitch W in shared memory, and a thread's share of their copies.
//
// f32 and f64: the points e = threadIdx.x + k nt (nt = ty / R * tz
// threads); tab[e] = {the point's offset y Nz + z in a plane, or -1 outside
// the grid; its index in the window}. Each thread writes and reads only its
// own entries, so the table needs no barrier.
//
// bf16 (copy_width 2): cp.async copies 4 bytes at least, and on the
// unpadded grid (Nz = 257 at 64 cells, p = 4) a row's global alignment
// changes from row to row and plane to plane. So the pitch W has Nz's
// parity, and plane g's window starts shift(g) elements into its slot,
// the parity of the window's first global index: a window point then has
// the parity of its global index, and the pairs of the slot, 4-byte
// aligned on both sides, are one cp.async each (copy_pair). off[l] (l = r
// W + col over the whole pitch) is the point's offset in a plane, or -1
// outside the grid or in the pitch's gap; the threads read each other's
// entries (a barrier follows the constructor).
template <typename T, int P>
struct GridWindow {
  static constexpr int V = copy_width<T>();
  int W, n, nt, wc;
  int2* tab;  // f32, f64
  int* off;   // bf16

  __device__ GridWindow(const PaddedBox& s, const TileCoords& c,
                        const Tiling& t, int R, void* table)
      : W(window_pitch<T>(t.tz, P, R, s.nz)), nt(t.ty / R * t.tz),
        wc(t.tz + 2 * P), tab(reinterpret_cast<int2*>(table)),
        off(reinterpret_cast<int*>(table)) {
    const int rows = t.ty + 2 * P;
    n = V == 2 ? rows * W : rows * wc;
    const int pitch = V == 2 ? W : wc;
    for (int e = (int)threadIdx.x; e < n; e += nt) {
      const int r = e / pitch;
      const int col = e - r * pitch;
      const int yy = c.y0 - P + r;
      const int zz = c.z0 - P + col;
      const bool in = col < wc && yy >= 0 && yy < s.ny && zz >= 0 && zz < s.nz;
      if constexpr (V == 2) {
        off[e] = in ? yy * s.Lz + zz : -1;
      } else {
        tab[e] = make_int2(in ? yy * s.Lz + zz : -1, r * W + col);
      }
    }
  }

  // The shift of plane g's window in its slot (0 but for bf16).
  __device__ __forceinline__ int shift(const PaddedBox& s, const TileCoords& c,
                                       int g) const {
    if constexpr (V == 2) {
      return (int)(((long long)g * s.F() + (long long)(c.y0 - P) * s.Lz + c.z0 -
                    P) & 1);
    } else {
      return 0;
    }
  }

  // Start the copies of plane g of x into the slot dst; points outside the
  // grid become 0 without a load.
  __device__ __forceinline__ void fetch(T* dst, const T* x, const PaddedBox& s,
                                        const TileCoords& c, int g) const {
    const bool gx = g >= 0 && g < s.nx;
    const long long row = (long long)g * s.F();
    if constexpr (V == 2) {
      const int b = shift(s, c, g);
      for (int u = (int)threadIdx.x; 2 * u < n + b; u += nt) {
        const int l0 = 2 * u - b, l1 = l0 + 1;
        const int o0 = l0 >= 0 ? off[l0] : -1, o1 = l1 < n ? off[l1] : -1;
        const bool in0 = gx && o0 >= 0, in1 = gx && o1 >= 0;
        const long long j0 = in0 ? row + o0 : in1 ? row + o1 : 0;
        const long long j1 = in1 ? row + o1 : j0;
        copy_pair(dst + 2 * u, x + j0, x + j1, in0, in1);
      }
    } else {
      for (int e = (int)threadIdx.x; e < n; e += nt) {
        const int2 d = tab[e];
        const bool in = gx && d.x >= 0;
        cp_async_or_zero(dst + d.y, x + (in ? row + d.x : 0), in);
      }
    }
  }
};

// Dynamic shared memory of a block: the ring of kPipe slots, then the
// window's copy table.
template <typename T, int P>
inline int grid_smem_bytes(const Tiling& t, int R, int Nz) {
  const int rows = t.ty + 2 * P;
  const int W = window_pitch<T>(t.tz, P, R, Nz);
  return kPipe * window_slot<T>(rows, W) * (int)sizeof(T) +
         (copy_width<T>() == 2 ? rows * W * (int)sizeof(int)
                               : rows * (t.tz + 2 * P) * (int)sizeof(int2));
}

// sum_k c[k] v[(k - P) stride], the taps in k order, in c's type
template <typename A, typename T, int P>
__device__ __forceinline__ A axis_taps(const A (&c)[2 * P + 1], const T* v,
                                       int stride) {
  A acc = A(0);
#pragma unroll
  for (int k = 0; k < 2 * P + 1; ++k) acc += c[k] * widen(v[(k - P) * stride]);
  return acc;
}

template <typename T, int P>
__global__ void __launch_bounds__(kTileThreads, (tma_min_blocks<T>()))
    stiffness_tiled_kernel(const T* __restrict__ x, T* __restrict__ y,
                           GridStencil<T> s, Tiling t) {
  using A = Acc<T>;
  constexpr int K = 2 * P + 1;
  constexpr int R = grid_rows<T, P>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const TileCoords c(s, t);  // c.ly: the thread's group of R rows
  const int W = window_pitch<T>(t.tz, P, R, s.nz);
  const int plane = window_slot<T>(t.ty + 2 * P, W);
  const GridWindow<T, P> w(s, c, t, R, smem + kPipe * plane);
  if (copy_width<T>() == 2) __syncthreads();  // the table is shared
  const int F = s.F();
  const int iters = c.xe - c.xs + 2 * P;  // planes xs - P .. xe + P - 1
#pragma unroll
  for (int i = 0; i < kPipe - 1; ++i) {
    if (i < iters) w.fetch(smem + i * plane, x, s, c, c.xs - P + i);
    cp_async_commit();
  }

  // the thread's rows y0 + R ly + r of column z: their flat (y, z) index,
  // whether they lie in the grid, their y tables and lines
  int f[R];
  bool act[R];
  A cy[R][K], ly[R];
  const bool zin = c.z < s.nz;
  const A lz = zin ? widen(__ldg(&s.lz[c.z])) : A(0);
  A cz[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    cz[k] = zin ? widen(__ldg(&s.cvz[k * s.Lz + c.z])) : A(0);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int yr = c.y0 + R * c.ly + r;
    f[r] = yr * s.Lz + c.z;
    act[r] = zin && yr < s.ny;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      cy[r][k] = act[r] ? widen(__ldg(&s.cvy[k * s.Ly + yr])) : A(0);
    }
    ly[r] = act[r] ? widen(__ldg(&s.ly[yr])) : A(0);
  }
  A q[R][K];  // q[r][k] = x of row r at plane gi - 2P + k after plane gi
  A yq[R][P], zq[R][P];  // ty lx lz, tz lx ly at plane gi - P + 1 + j
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int k = 0; k < K; ++k) q[r][k] = A(0);
#pragma unroll
    for (int j = 0; j < P; ++j) yq[r][j] = zq[r][j] = A(0);
  }

  for (int i = 0; i < iters; ++i) {
    const int gi = c.xs - P + i;
    const T* buf = smem + (i % kPipe) * plane + w.shift(s, c, gi);
    cp_async_wait<kPipe - 2>();  // this thread's copies of plane gi landed
    __syncthreads();  // plane gi is complete; slot (i - 1) % kPipe is free
    const int ip = i + kPipe - 1;
    if (ip < iters) w.fetch(smem + (ip % kPipe) * plane, x, s, c, c.xs - P + ip);
    cp_async_commit();

    const T* ctr = buf + (R * c.ly + P) * W + (c.lz + P);  // row 0's point
    A ty[R], tz[R];
    const bool run = gi >= c.xs && gi < c.xe;
    const A lx = run ? widen(__ldg(&s.lx[gi])) : A(0);
    A v[K + R - 1];  // the y taps of the R rows: rows -P .. P + R - 1
#pragma unroll
    for (int j = 0; j < K + R - 1; ++j) {
      v[j] = run || (j >= P && j < P + R) ? widen(ctr[(j - P) * W]) : A(0);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int k = 0; k < K - 1; ++k) q[r][k] = q[r][k + 1];
      q[r][K - 1] = v[P + r];
      ty[r] = tz[r] = A(0);
      if (run) {
        A acc = A(0);
#pragma unroll
        for (int k = 0; k < K; ++k) acc += cy[r][k] * v[k + r];
        ty[r] = acc * (lx * lz);
        tz[r] = axis_taps<A, T, P>(cz, ctr + r * W, 1) * (lx * ly[r]);
      }
    }
    A ay[R], az[R];
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
    A tx[R];
#pragma unroll
    for (int r = 0; r < R; ++r) tx[r] = A(0);
#pragma unroll
    for (int k = 0; k < K; ++k) {  // x_taps, one coefficient load for R rows
      const A cxk = widen(__ldg(&s.cvx[k * s.Lx + g]));
#pragma unroll
      for (int r = 0; r < R; ++r) tx[r] += cxk * q[r][k];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (act[r]) {
        y[(long long)g * F + f[r]] =
            narrow<T>((tx[r] * (ly[r] * lz) + ay[r]) + az[r]);
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
      (int)grid.z != cdiv(s.nx, t.cx) ||
      smem < grid_smem_bytes<T, P>(t, R, s.nz) ||
      (copy_width<T>() == 2 && (uintptr_t)x % 4 != 0)) {
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
WAVE_DEFINE_STIFFNESS_TILED(__nv_bfloat16, bf16)
