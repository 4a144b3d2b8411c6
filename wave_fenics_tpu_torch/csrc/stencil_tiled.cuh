// The padded wave stencil of stencil.cuh, streamed along x through shared
// memory (2.5D tiling), for kernels that apply A once per point of a tile.
//
// A block owns a ty x tz tile of interior (y, z) columns, one thread per
// column, and walks one x-chunk of cx interior rows plus p warm-up rows on
// each side. Each x plane of the tile and its p-deep y/z halo is copied
// into shared memory once (cp.async, zeros outside the interior without a
// load); the y and z taps are read from there, the x taps from a register
// queue of the column's last 2p + 1 plane values, and the column's y/z
// tables stay in registers for the whole chunk. The sums keep the order of
// stencil.cuh's apply_stencil: the x taps in k order; the merged shift-0
// y/z tap, the y taps, the z taps; then tx * fx + yz * sx.
//
// The tiling (ty, tz, cx and the grid: z tiles, y tiles, x-chunks) comes
// from the caller (ops/rk4step.py::tiled_geometry). Each block also writes
// zeros to its share of the outputs' padding rows, while its first planes
// are in flight.
#pragma once

#include <cuda_runtime.h>

#include "stencil.cuh"

namespace wave {

constexpr int kTileThreads = 256;  // at most ty * tz threads per block
constexpr int kPipe = 4;           // x planes in the cp.async ring

struct Tiling {
  int ty, tz, cx;  // interior points of a tile along y and z; x-chunk rows
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// dst = *src when load, else dst = 0 (src is not read; it must still be a
// valid global address).
template <typename T>
__device__ __forceinline__ void cp_async_or_zero(T* dst, const T* src,
                                                 bool load) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"((int)sizeof(T)),
               "r"(load ? (int)sizeof(T) : 0));
}

// Where a tile block sits: its first interior y and z, its x rows
// [xs, xe), its thread's column (y, z) and flat column index f.
template <typename T>
struct TileCoords {
  int y0, z0, xs, xe, ly, lz, y, z, f;
  bool active;  // the thread's column is an interior column

  __device__ TileCoords(const Stencil<T>& s, const Tiling& t) {
    ly = (int)threadIdx.x / t.tz;
    lz = (int)threadIdx.x - ly * t.tz;
    y0 = s.h + (int)blockIdx.y * t.ty;
    z0 = s.h + (int)blockIdx.x * t.tz;
    xs = s.x0 + (int)blockIdx.z * t.cx;
    xe = min(xs + t.cx, s.x0 + s.nx);
    y = y0 + ly;
    z = z0 + lz;
    f = y * s.Lz + z;
    active = y < s.h + s.ny && z < s.h + s.nz;
  }
};

// The tile's (ty + 2P) x (tz + 2P) plane window (pitch W = tz + 2P) and a
// thread's share of it, the elements e = threadIdx.x + k * nt. off[e] (in
// shared memory) is the element's (y, z) offset in a plane, y * Lz + z, or
// -1 outside the interior; each thread writes and reads only its own
// entries, so the table needs no barrier.
template <int P>
struct Window {
  int W, n, nt;  // pitch, window points, threads
  int* off;

  template <typename T>
  __device__ Window(const Stencil<T>& s, const TileCoords<T>& c,
                    const Tiling& t, int* table)
      : W(t.tz + 2 * P), n((t.ty + 2 * P) * (t.tz + 2 * P)), nt(t.ty * t.tz),
        off(table) {
    for (int e = (int)threadIdx.x; e < n; e += nt) {
      const int r = e / W;
      const int yy = c.y0 - P + r;
      const int zz = c.z0 - P + (e - r * W);
      off[e] = yy >= s.h && yy < s.h + s.ny && zz >= s.h && zz < s.h + s.nz
                   ? yy * s.Lz + zz
                   : -1;
    }
  }
};

// Start the copies of plane g of the fields f0..f(NF-1) over the window
// into dst (field-major); points outside the interior become 0 without a
// load. Each thread copies its own elements of the window.
template <typename T, int P, int NF>
__device__ __forceinline__ void fetch_plane(T* dst, const T* f0, const T* f1,
                                            const T* f2, const Stencil<T>& s,
                                            const Window<P>& w, int g) {
  const bool gx = g >= s.x0 && g < s.x0 + s.nx;
  const long long row = (long long)g * s.F();
  for (int e = (int)threadIdx.x; e < w.n; e += w.nt) {
    const int o = w.off[e];
    const bool in = gx && o >= 0;
    const long long j = in ? row + o : 0;
    cp_async_or_zero(dst + e, f0 + j, in);
    if constexpr (NF > 1) cp_async_or_zero(dst + w.n + e, f1 + j, in);
    if constexpr (NF > 2) cp_async_or_zero(dst + 2 * w.n + e, f2 + j, in);
  }
}

// The y/z tables of one column, held in registers for a whole chunk.
template <typename T, int P>
struct ColumnTables {
  static constexpr int K = 2 * P + 1;
  T cy[K], cz[K];
  T fx;

  __device__ __forceinline__ void load(const Stencil<T>& s, int f,
                                       bool active) {
    const int F = s.F();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      cy[k] = active ? s.cvy[k * F + f] : T(0);
      cz[k] = active ? s.cvz[k * F + f] : T(0);
    }
    fx = active ? s.fx[f] : T(0);
  }

  // The y/z sum at the point `c` of a shared plane of pitch W.
  __device__ __forceinline__ T yz(const T* c, int W) const {
    T acc = (cy[P] + cz[P]) * c[0];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k != P) acc += cy[k] * c[(k - P) * W];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k != P) acc += cz[k] * c[k - P];
    }
    return acc;
  }
};

// The x sum of row g from the column's queue q[k] = x[g + k - P].
template <typename T, int P>
__device__ __forceinline__ T x_taps(const Stencil<T>& s, const T (&q)[2 * P + 1],
                                    int g) {
  T tx = T(0);
#pragma unroll
  for (int k = 0; k < 2 * P + 1; ++k) tx += __ldg(&s.cvx[k * s.Lx + g]) * q[k];
  return tx;
}

// This block's share of writing 0 to every padding point of o0 (and of o1
// when it is not null): one (x, y) row of Lz points per group of up to 32
// threads, the rows dealt round-robin over all the grid's groups.
template <typename T>
__device__ void zero_padding(const Stencil<T>& s, const Tiling& t, T* o0,
                             T* o1) {
  const int nt = t.ty * t.tz;
  const int gs = nt < 32 ? nt : 32;
  const int groups = nt / gs;
  const int grp = (int)threadIdx.x / gs;
  const int lane = (int)threadIdx.x - grp * gs;
  if (grp >= groups) return;
  const long long rows = (long long)s.Lx * s.Ly;
  const long long block =
      ((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  const long long step = (long long)gridDim.x * gridDim.y * gridDim.z * groups;
  for (long long row = block * groups + grp; row < rows; row += step) {
    const int g = (int)(row / s.Ly);
    const int y = (int)(row - (long long)g * s.Ly);
    const long long base = row * s.Lz;
    const bool full = g < s.x0 || g >= s.x0 + s.nx || y < s.h || y >= s.h + s.ny;
    const int z1 = full ? s.Lz : s.h;  // [0, z1) and [z2, Lz) are padding
    const int z2 = full ? s.Lz : s.h + s.nz;
    for (int z = lane; z < z1; z += gs) {
      o0[base + z] = T(0);
      if (o1) o1[base + z] = T(0);
    }
    for (int z = z2 + lane; z < s.Lz; z += gs) {
      o0[base + z] = T(0);
      if (o1) o1[base + z] = T(0);
    }
  }
}

// Bytes of dynamic shared memory a tile block of NF fields needs: the ring
// of kPipe planes, then the window's offset table.
template <typename T, int P>
inline int tiled_smem_bytes(const Tiling& t, int nf) {
  const int n = (t.ty + 2 * P) * (t.tz + 2 * P);
  return kPipe * nf * n * (int)sizeof(T) + n * (int)sizeof(int);
}

}  // namespace wave
