// Kernel G on Hopper (sm_90a): the consistent Gauss mass of CEED BP1 on the
// 2.5D tiled stencil of stencil_tiled.cuh with TMA plane loads.
//
// mass_tiled_kernel<T, P> replaces the TPU kernel
// wave_fenics_tpu/ops/pallas_mass.py::_kernel_mass: y = (Mx (x) My (x) Mz) x
// on the padded layout [Lx, Ly, Lz] of ops/mass.py (z_align 16), as three
// banded 1D contractions with the coefficient vectors cvx [K, Lx],
// cvy [K, Ly], cvz [K, Lz] (K = 2p + 1, each indexed by the output point):
//
//   tz[x, y, z] = sum_k cvz[k, z] x[x, y, z + k - p]
//   ty[x, y, z] = sum_k cvy[k, y] tz[x, y + k - p, z]
//   y[x, y, z]  = sum_k cvx[k, x] ty[x + k - p, y, z]
//
// The contraction order is z, then y, then x; the TPU kernel's (and the
// plain version's, ops/mass.py::mass_apply_plain) is x, y, z. Each sum
// starts from its shift-0 tap, then the others in k order, as the plain
// version's _band; ops/mass.py::mass_apply_zyx_plain is the plain twin in
// this kernel's order. The tables are zero outside the interior, so the
// interior of y does not depend on x's padding, and y's padding is 0.
//
// What bounds it on this card: x read once and y written once, two state
// passes (0.0471 ms in f32 at 64^3 cells, p = 4: 67.9 MB of x's interior,
// 90.0 MB of padded y, at 3.35 TB/s; half that in bf16, 0.0236 ms);
// 3(2p + 1) multiply-adds a point are far below the flop rate. The
// earlier brick form read each brick's
// (8 + 2p)^2 (32 + 2p) input box from L2 for 2,048 outputs, 5x the input,
// in three barrier phases with nothing in flight across them: 10.9x the
// bound.
//
// The design (kernel D's, rk_stage_tiled.cu): a block owns a ty x tz tile
// of interior (y, z) columns, one thread each, and streams one x-chunk
// with p warm-up planes on each side. Each plane's window of x, the tile
// and its p-deep y/z halo, arrives by one TMA request into a ring of kRing
// planes, kRing - 1 planes ahead, so x is read from HBM once and its halo
// from L2. Per plane, the z contraction over the window's ty + 2p rows
// (each thread the rows of its own column) goes into one of two
// z-contracted planes of (ty + 2p) x tz points, before the plane's one
// barrier; after it, each thread contracts y at its column. The column's
// cvz and cvy taps sit in registers for the whole chunk, cvx of the
// chunk's rows in shared memory (staged once), and the y-contracted
// values of the last 2p + 1 planes in a register queue, from which the x
// contraction of row g - p is taken. The padding of y is written by the
// grid's last layer of blocks (padding_block; last measured 3 % faster
// than first at the P7 size, where the tile blocks take several waves).
// P is a template parameter (p = 1..8); the launch bounds ask for two
// 256-thread blocks an SM in f32 and bf16.
//
// bf16 state (T = __nv_bfloat16; f32 and f64 take the same code with
// Acc<T> = T): x, y and the three tables are bf16 (a BFLOAT16 tensor map;
// a bf16 box starts on an 8-point unit, so the tiling's tz is a multiple
// of 8 and oz = (h - P) mod 8), every tap widens to float32
// (stencil_tiled.cuh::Acc) and all three contractions run in float32: the
// two z-contracted planes hold float32 (kZ = 2 boxes of T each), and y is
// rounded once where it is stored. The TPU kernel rounds its x-contracted
// t1 to the state dtype and accumulates y and z in bf16 scratch
// (pallas_mass.py:84-106); ops/mass.py::mass_apply_zyx_plain is this
// kernel's twin, rounding as it does.
//
// The extern "C" launcher returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for a tiling that does not fit the layout, too
// little shared memory, y aliasing x, or a tensor map that
// cuTensorMapEncodeTiled refuses.

#include <cuda.h>
#include <cuda_runtime.h>

#include "stencil_tiled.cuh"

namespace wave {

template <typename T>
struct MassArgs {
  const T* x;
  T* y;
  const T* cvx;  // [K, Lx]
  const T* cvy;  // [K, Ly]
  const T* cvz;  // [K, Lz]
};

// Boxes of T that one z-contracted plane of Acc<T> takes: 1, or 2 for bf16.
template <typename T>
__host__ __device__ constexpr int z_boxes() {
  return (int)(sizeof(Acc<T>) / sizeof(T));
}

// Dynamic shared memory of a block: the ring of x's windows, two
// z-contracted planes of Acc<T>, then cvx of a chunk's rows, [K][cx].
template <typename T, int P>
inline int mass_smem_bytes(const TmaWindow& w, const Tiling& t) {
  return tma_smem_bytes<T>(w, 1, 2 * z_boxes<T>()) + (2 * P + 1) * t.cx * (int)sizeof(T);
}

// sum_k c[k] v[k * stride] in A, the shift-0 tap first, then the others in
// k order (v widened at the tap)
template <typename A, int P, typename V>
__device__ __forceinline__ A band(const A (&c)[2 * P + 1], const V* v,
                                  int stride) {
  A acc = c[P] * widen(v[P * stride]);
#pragma unroll
  for (int k = 0; k < 2 * P + 1; ++k) {
    if (k != P) acc += c[k] * widen(v[k * stride]);
  }
  return acc;
}

template <typename T, int P>
__global__ void __launch_bounds__(kTileThreads, (tma_min_blocks<T>()))
    mass_tiled_kernel(const __grid_constant__ CUtensorMap xmap, PaddedBox s,
                      MassArgs<T> a, Tiling t) {
  using A = Acc<T>;
  constexpr int K = 2 * P + 1;
  constexpr int ZB = z_boxes<T>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  long long pb, npb;
  if (padding_block(s, t, pb, npb)) {  // the grid's last layer: y's padding
    T* y = a.y;
    for_each_padding<1>(s, t, pb, npb,
                        [y](const int (&i)[1], int) { y[i[0]] = zero<T>(); });
    return;
  }

  const TileCoords c(s, t);
  const TmaWindow w = tma_window<T>(s, t, P);
  const PlaneRing<T> ring(smem_raw, w, 1, 2 * ZB);  // x; two z-contracted planes
  const int zs = c.z0 - P - w.oz;  // the box's origin in every plane
  const int ys = c.y0 - P;
  const int iters = c.xe - c.xs + 2 * P;  // planes xs - P .. xe + P - 1
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing - 1 && i < iters; ++i) {
      ring.fetch(i, &xmap, nullptr, zs, ys, c.xs - P + i);
    }
  }
  const int nt = t.ty * t.tz;
  // cvx of the chunk's rows; the first plane's barrier publishes it
  T* cx = reinterpret_cast<T*>(ring.end());
  const int rows = c.xe - c.xs;
  for (int e = (int)threadIdx.x; e < K * rows; e += nt) {
    const int k = e / rows;
    cx[k * t.cx + (e - k * rows)] = a.cvx[k * s.Lx + c.xs + (e - k * rows)];
  }
  // the column's taps: cvz wherever its z-contracted values are needed (a
  // column inside the interior along z), cvy at an interior column
  const bool zin = c.z < s.h + s.nz;
  A cz[K], cy[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    cz[k] = zin ? widen(a.cvz[k * s.Lz + c.z]) : A(0);
    cy[k] = c.active ? widen(a.cvy[k * s.Ly + c.y]) : A(0);
  }
  A q[K];  // q[k] = the y/z-contracted value at row gi - 2P + k after plane gi
#pragma unroll
  for (int k = 0; k < K; ++k) q[k] = A(0);

  const int F = s.F();
  const int W = w.W;
  const int tz = t.tz;
  const int nrow = t.ty + 2 * P;  // rows of a window and of a z-contracted plane
  for (int i = 0; i < iters; ++i) {
    const int gi = c.xs - P + i;
    ring.wait(i);
    // z: the rows ly, ly + ty, ... of the thread's column (the elements
    // threadIdx.x + j * nt of the (ty + 2P) x tz plane)
    const T* xb = ring.slot(i) + w.oz + c.lz;
    A* zb = reinterpret_cast<A*>(ring.extra((i & 1) * ZB));
    for (int r = c.ly; r < nrow; r += t.ty) zb[r * tz + c.lz] = band<A, P>(cz, xb + r * W, 1);
    __syncthreads();  // the z-contracted plane gi is complete, and every
                      // thread is past plane gi - 1: refill its slot
    if (threadIdx.x == 0 && i + kRing - 1 < iters) {
      ring.fetch(i + kRing - 1, &xmap, nullptr, zs, ys, gi + kRing - 1);
    }
    if (!c.active) continue;
    const A v = band<A, P>(cy, zb + c.ly * tz + c.lz, tz);  // y at the column
#pragma unroll
    for (int k = 0; k < K - 1; ++k) q[k] = q[k + 1];
    q[K - 1] = v;

    if (i < 2 * P) continue;
    const int g = gi - P;  // the output row
    const T* cg = cx + (g - c.xs);  // cvx[k, g] at cg[k * cx]
    A acc = widen(cg[P * t.cx]) * q[P];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k != P) acc += widen(cg[k * t.cx]) * q[k];
    }
    a.y[(long long)g * F + c.f] = narrow<T>(acc);
  }
}

template <typename T, int P>
int launch_mass_p(PaddedBox s, MassArgs<T> a, Tiling t, dim3 grid, int smem,
                  cudaStream_t stream) {
  const TmaWindow w = tma_window<T>(s, t, P);
  if (!tma_fits<T>(s, t, w, a.x) || smem < mass_smem_bytes<T, P>(w, t)) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap xmap;
  const int e = encode_plane_map<T>(&xmap, a.x, s, w);
  if (e != 0) return e;
  auto kernel = mass_tiled_kernel<T, P>;
  if (smem > 48 * 1024) {
    const cudaError_t r = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (r != cudaSuccess) return (int)r;
  }
  kernel<<<grid, t.ty * t.tz, smem, stream>>>(xmap, s, a, t);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_mass_tiled(PaddedBox s, MassArgs<T> a, Tiling t, dim3 grid,
                      int smem, cudaStream_t stream) {
  if (!tma_tiling_fits(t, grid, s.nx, s.ny, s.nz) || !box_fits_int(s) ||
      s.x0 < s.p || s.h < s.p || a.y == a.x) {
    return (int)cudaErrorInvalidValue;
  }
  switch (s.p) {
    case 1: return launch_mass_p<T, 1>(s, a, t, grid, smem, stream);
    case 2: return launch_mass_p<T, 2>(s, a, t, grid, smem, stream);
    case 3: return launch_mass_p<T, 3>(s, a, t, grid, smem, stream);
    case 4: return launch_mass_p<T, 4>(s, a, t, grid, smem, stream);
    case 5: return launch_mass_p<T, 5>(s, a, t, grid, smem, stream);
    case 6: return launch_mass_p<T, 6>(s, a, t, grid, smem, stream);
    case 7: return launch_mass_p<T, 7>(s, a, t, grid, smem, stream);
    case 8: return launch_mass_p<T, 8>(s, a, t, grid, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace wave

// ---------------------------------------------------------------------------
// Plain C interface (bound with ctypes by ops/_cuda.py). The last seven
// ints are ops/mass.py::mass_launch_args's tiling: ty, tz, cx, the grid
// (gx, gy, gz) of ops/tiling.py::tma_geometry (fields=1, extra=2, or 4 for
// bf16: the float32 z-contracted planes) and the
// dynamic shared memory in bytes (with cvx of a chunk's rows).
// ---------------------------------------------------------------------------

#define WAVE_DEFINE_MASS_TILED(T, SUFFIX)                                     \
  extern "C" int wave_mass_tiled_##SUFFIX(                                    \
      const T* x, T* y, const T* cvx, const T* cvy, const T* cvz, int p,      \
      int Lx, int Ly, int Lz, int x0, int nx, int h, int ny, int nz, int ty,  \
      int tz, int cx, int gx, int gy, int gz, int smem, cudaStream_t stream) { \
    wave::MassArgs<T> a{x, y, cvx, cvy, cvz};                                 \
    wave::PaddedBox s{p, Lx, Ly, Lz, x0, nx, h, ny, nz};                      \
    return wave::launch_mass_tiled<T>(s, a, wave::Tiling{ty, tz, cx},         \
                                      dim3(gx, gy, gz), smem, stream);        \
  }

WAVE_DEFINE_MASS_TILED(float, f32)
WAVE_DEFINE_MASS_TILED(double, f64)
WAVE_DEFINE_MASS_TILED(__nv_bfloat16, bf16)
