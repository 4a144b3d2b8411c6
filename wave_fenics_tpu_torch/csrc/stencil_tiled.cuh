// The padded wave stencil of stencil.cuh, streamed along x through shared
// memory (2.5D tiling), for kernels that apply A once per point of a tile.
//
// A block owns a ty x tz tile of interior (y, z) columns, one thread per
// column, and walks one x-chunk of cx interior rows plus p warm-up rows on
// each side. Each x plane of the tile and its p-deep y/z halo arrives in
// shared memory once; the y and z taps are read from there, the x taps
// from a register queue of the column's last 2p + 1 plane values, and the
// column's y/z tables stay in registers for the whole chunk. The sums of
// the flat layout's kernels keep one order (that of ops/wave.py::
// apply_stencil_plain): the x taps in k order (x_taps); the merged shift-0
// y/z tap, the y taps, the z taps (ColumnTables::yz); then tx * fx + yz *
// sx.
//
// The tiling (ty, tz, cx and the grid: z tiles, y tiles, x-chunks) comes
// from the caller (ops/tiling.py). The outputs' padding is written by
// layers of padding blocks beside the tile blocks (padding_block).
//
// The geometry helpers take the table-free PaddedBox, which every
// layout's stencil provides: kernels A and C (rk4_tiled.cu), B
// (flat_tiled.cu), D (rk_stage_tiled.cu), H and I (lf_tiled.cu) and J's
// step boundary (rk42_tiled.cu) on the flat layout, kernel E
// (slab_tiled.cu) on the 3D slab, kernel G (mass_tiled.cu, the BP1 mass)
// on its padded layout, and kernel F (stiffness_tiled.cu) on the unpadded
// dof grid, a box with no padding. F copies its planes element by element
// with cp.async into a window of its own; the others take each plane
// window of a field with one TMA request into a ring of planes (PlaneRing,
// the end of this file), so no thread spends instructions on the copy.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "stencil.cuh"

namespace wave {

// ---------------------------------------------------------------------------
// Storage and arithmetic types. The state, the stage fields and the tables
// are stored as T; the arithmetic runs in Acc<T>: T itself for float and
// double, float for __nv_bfloat16 (bf16 state: kernels A to F, H, I and
// J).
// Every load of a T widens to Acc<T> (widen) and every store rounds once
// (narrow<T>, round to nearest even), so no bf16 arithmetic rounds a
// partial sum.
// ---------------------------------------------------------------------------

template <typename T>
struct AccOf {
  using type = T;
};
template <>
struct AccOf<__nv_bfloat16> {
  using type = float;
};
template <typename T>
using Acc = typename AccOf<T>::type;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T narrow(Acc<T> x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__device__ __forceinline__ T zero() {
  return narrow<T>(Acc<T>(0));
}

// Elements a thread of kernel F copies into a plane window at a time:
// cp.async moves 4, 8 or 16 bytes, so a bf16 window is copied in pairs
// (copy_pair).
template <typename T>
__host__ __device__ constexpr int copy_width() {
  return sizeof(T) == 2 ? 2 : 1;
}

constexpr int kTileThreads = 256;  // at most ty * tz threads per block
constexpr int kPipe = 4;           // x planes in kernel F's cp.async ring

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

// Copy the bf16 pair of points src0, src1 (in0, in1: whether each is in
// the load box) to dst (4-byte aligned): one 4-byte cp.async where both are
// in and src1 = src0 + 1 (src0 then 4-byte aligned), zeros without a load
// where neither is. A pair that straddles the edge of the load box (or two
// points that are not neighbours in memory) takes plain loads of its inner
// points and writes 0 beside them, so the zeros outside stay exact.
// src0/src1 must be valid global addresses even where they are not read.
__device__ __forceinline__ void copy_pair(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src0,
                                          const __nv_bfloat16* src1, bool in0,
                                          bool in1) {
  if (in0 ? in1 && src1 == src0 + 1 : !in1) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src0), "r"(in0 ? 4 : 0));
  } else {
    const __nv_bfloat16 z = __float2bfloat16_rn(0.0f);
    *reinterpret_cast<__nv_bfloat162*>(dst) =
        __halves2bfloat162(in0 ? src0[0] : z, in1 ? src1[0] : z);
  }
}

// Where a tile block sits: its first interior y and z, its x rows
// [xs, xe), its thread's column (y, z) and flat column index f.
struct TileCoords {
  int y0, z0, xs, xe, ly, lz, y, z, f;
  bool active;  // the thread's column is an interior column

  // zoff: layers of padding blocks before the x-chunks (padding_block)
  __device__ TileCoords(const PaddedBox& s, const Tiling& t, int zoff = 0) {
    ly = (int)threadIdx.x / t.tz;
    lz = (int)threadIdx.x - ly * t.tz;
    y0 = s.h + (int)blockIdx.y * t.ty;
    z0 = s.h + (int)blockIdx.x * t.tz;
    xs = s.x0 + ((int)blockIdx.z - zoff) * t.cx;
    xe = min(xs + t.cx, s.x0 + s.nx);
    y = y0 + ly;
    z = z0 + lz;
    f = y * s.Lz + z;
    active = y < s.h + s.ny && z < s.h + s.nz;
  }
};

// The y/z tables of one column, held in registers (widened to Acc<T>) for
// a whole chunk.
template <typename T, int P>
struct ColumnTables {
  static constexpr int K = 2 * P + 1;
  using A = Acc<T>;
  A cy[K], cz[K];
  A fx;

  __device__ __forceinline__ void load(const Stencil<T>& s, int f,
                                       bool active) {
    const int F = s.F();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      cy[k] = active ? widen(s.cvy[k * F + f]) : A(0);
      cz[k] = active ? widen(s.cvz[k * F + f]) : A(0);
    }
    fx = active ? widen(s.fx[f]) : A(0);
  }

  // The y/z sum at the point `c` of a shared plane of pitch W.
  __device__ __forceinline__ A yz(const T* c, int W) const {
    A acc = (cy[P] + cz[P]) * widen(c[0]);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k != P) acc += cy[k] * widen(c[(k - P) * W]);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k != P) acc += cz[k] * widen(c[k - P]);
    }
    return acc;
  }
};

// The x sum of row g from the column's queue q[k] = x[g + k - P] (in the
// arithmetic type A); cvx is [K, Lx] in both layouts' tables (Stencil,
// SlabStencil).
template <typename A, int P, typename S>
__device__ __forceinline__ A x_taps(const S& s, const A (&q)[2 * P + 1], int g) {
  A tx = A(0);
#pragma unroll
  for (int k = 0; k < 2 * P + 1; ++k) {
    tx += widen(__ldg(&s.cvx[k * s.Lx + g])) * q[k];
  }
  return tx;
}

// The share of the padding points of the state that block `block` of the
// `blocks` blocks sharing them takes: one (x, y) row of Lz points per
// group of gs = min(32, threads) threads, the rows dealt round-robin over
// all those blocks' groups, a row's padding points (all Lz of a row
// outside the interior rows, else the z points outside [h, h + nz)) dealt
// over the group's lanes. fn(idx, n) takes a thread's points U at a time
// (flat indices idx[0..n), n < U only for the last; the launchers check
// that they fit an int), so that a pass which reads fields can issue the
// loads of U points before their stores.
template <int U, typename Fn>
__device__ void for_each_padding(const PaddedBox& s, const Tiling& t,
                                 long long block, long long blocks,
                                 const Fn& fn) {
  const int nt = t.ty * t.tz;
  const int gs = nt < 32 ? nt : 32;
  const int groups = nt / gs;
  const int grp = (int)threadIdx.x / gs;
  const int lane = (int)threadIdx.x - grp * gs;
  if (grp >= groups) return;
  const long long rows = (long long)s.Lx * s.Ly;
  const long long step = blocks * groups;
  int idx[U];
  int n = 0;
  for (long long row = block * groups + grp; row < rows; row += step) {
    const int g = (int)(row / s.Ly);
    const int y = (int)(row - (long long)g * s.Ly);
    const int base = (int)row * s.Lz;
    const bool full = g < s.x0 || g >= s.x0 + s.nx || y < s.h || y >= s.h + s.ny;
    const int z1 = full ? s.Lz : s.h;  // [0, z1) and [z1 + gap, Lz) are padding
    const int gap = full ? 0 : s.nz;
    for (int k = lane; k < s.Lz - gap; k += gs) {
      const int i = base + (k < z1 ? k : k + gap);
#pragma unroll
      for (int j = 0; j < U; ++j) {
        if (j == n) idx[j] = i;
      }
      if (++n == U) {
        fn(idx, U);
        n = 0;
      }
    }
  }
  if (n > 0) fn(idx, n);
}

// The padded state's flat indices must fit an int (for_each_padding).
inline bool box_fits_int(const PaddedBox& s) {
  return (long long)s.Lx * s.Ly * s.Lz < 2147483647LL;
}

// The tiling must cover the interior exactly: one block per tile and
// x-chunk.
inline bool tiling_fits(const Tiling& t, dim3 grid, int nx, int ny, int nz) {
  const auto cdiv = [](int n, int d) { return (n + d - 1) / d; };
  return t.ty > 0 && t.tz > 0 && t.cx > 0 && t.ty * t.tz <= kTileThreads &&
         (int)grid.x == cdiv(nz, t.tz) && (int)grid.y == cdiv(ny, t.ty) &&
         (int)grid.z == cdiv(nx, t.cx);
}

// ---------------------------------------------------------------------------
// The TMA plane ring of kernels A to E, G, H, I and J's boundary (sm_90).
//
// Thread 0 asks the Tensor Memory Accelerator for the whole window of plane
// g, the box {W, ty + 2P, 1} of a 3D tensor map over the padded state
// [Lx, Ly, Lz], and the copy reports its bytes to the slot's mbarrier.
// Every thread waits on that barrier (the parity of the slot's use), then
// one __syncthreads per plane says that every thread is past the previous
// plane, whose slot thread 0 then refills R - 1 planes ahead (a ring of
// R = kRing slots, or fewer where a plane holds many fields). The
// window is read as it is in memory: the state's padding as it holds it,
// zeros beyond the tensor's ends.
//
// A box's z start must be 16-byte aligned (a z start that is not is an
// illegal instruction on the H100), so the box starts oz = (h - P) mod A
// points before the tile's halo, A = 16 / sizeof(T), and tz is a multiple
// of A, which gives every tile the same oz. Its z extent, the window's
// pitch W, is tz plus a multiple of 32 (so a multiple of A, as the box's
// inner extent must be a multiple of 16 bytes): thread (ly, lz) then reads
// its taps at ly W + lz + const, the same bank as its thread index, and no
// warp's shared-memory tap load has a bank conflict.
// ---------------------------------------------------------------------------

constexpr int kRing = 6;      // plane windows in the TMA ring
constexpr int kBoxMax = 256;  // a TMA box's extent along any axis at most

// Tile blocks per SM the register budget must allow for the TMA kernels
// and kernel F: two in f32 and bf16 (128 registers a thread), one in f64.
template <typename T>
__host__ __device__ constexpr int tma_min_blocks() {
  return sizeof(T) <= 4 ? 2 : 1;
}

// z points of one 16-byte unit of T
template <typename T>
__host__ __device__ constexpr int tma_align() {
  return 16 / (int)sizeof(T);
}

// The window a TMA block fetches for a plane: pitch W (the box's z extent,
// tz plus a multiple of 32), BY = ty + 2P rows, the halo's offset oz in
// the box's rows, and box, the
// elements a box takes in shared memory (its bytes rounded up to 128, so
// every box starts 128-byte aligned).
struct TmaWindow {
  int W, BY, oz, box;
};

template <typename T>
__host__ __device__ inline TmaWindow tma_window(const PaddedBox& s,
                                                const Tiling& t, int P) {
  constexpr int A = tma_align<T>();
  const int oz = ((s.h - P) % A + A) % A;
  const int W = t.tz + (oz + 2 * P + 31) / 32 * 32;
  const int BY = t.ty + 2 * P;
  const int bytes = (W * BY * (int)sizeof(T) + 127) / 128 * 128;
  return TmaWindow{W, BY, oz, bytes / (int)sizeof(T)};
}

// Dynamic shared memory of a TMA tile block: 128 bytes to align the base,
// `ring` slots (kRing unless the kernel's PlaneRing says otherwise) of nf
// boxes and `extra` boxes, then the ring's mbarriers.
template <typename T>
inline int tma_smem_bytes(const TmaWindow& w, int nf, int extra,
                          int ring = kRing) {
  return 128 + (ring * nf + extra) * w.box * (int)sizeof(T) +
         ring * (int)sizeof(uint64_t);
}

// The TMA kernels' grid has one more layer of x-chunks than the tiling
// needs: its blocks write the outputs' padding (padding_block) while the
// tile blocks stream their chunks, in the block slots the tiles leave
// free, instead of every tile block passing over its share first.
inline bool tma_tiling_fits(const Tiling& t, dim3 grid, int nx, int ny,
                            int nz) {
  return grid.z >= 2 && tiling_fits(t, dim3(grid.x, grid.y, grid.z - 1), nx, ny, nz);
}

// The layers of padding blocks in the grid beyond its x-chunks.
__device__ __forceinline__ int padding_layers(const PaddedBox& s, const Tiling& t) {
  return (int)gridDim.z - (s.nx + t.cx - 1) / t.cx;
}

// Whether this block is one of the padding layer's; if so, its index
// `block` among the layer's `blocks` blocks. The layer is the grid's last
// (First = false) or its first, whose blocks are dispatched with the first
// wave of tile blocks (First = true; the tile blocks then take
// TileCoords(s, t, padding_layers(s, t))).
template <bool First = false>
__device__ __forceinline__ bool padding_block(const PaddedBox& s,
                                              const Tiling& t, long long& block,
                                              long long& blocks) {
  const int layers = padding_layers(s, t);
  const int z = First ? (int)blockIdx.z : (int)blockIdx.z - ((int)gridDim.z - layers);
  if (z < 0 || z >= layers) return false;
  block = ((long long)z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  blocks = (long long)layers * gridDim.y * gridDim.x;
  return true;
}

// The TMA kernels' conditions on the layout and the tiling beyond
// tma_tiling_fits: tz a multiple of A, the box within kBoxMax, and the
// state's rows and base 16-byte aligned (the tensor map's rules).
template <typename T>
inline bool tma_fits(const PaddedBox& s, const Tiling& t, const TmaWindow& w,
                     const void* base) {
  return t.tz % tma_align<T>() == 0 && w.W <= kBoxMax && w.BY <= kBoxMax &&
         (s.Lz * sizeof(T)) % 16 == 0 && (uintptr_t)base % 16 == 0;
}

// The 3D tensor map of a padded state [Lx, Ly, Lz] with the box of `w`.
// Returns 0, or cudaErrorInvalidValue when the driver refuses the map.
template <typename T>
inline int encode_plane_map(CUtensorMap* map, const T* base, const PaddedBox& s,
                            const TmaWindow& w) {
  const cuuint64_t dims[3] = {(cuuint64_t)s.Lz, (cuuint64_t)s.Ly,
                              (cuuint64_t)s.Lx};
  const cuuint64_t strides[2] = {(cuuint64_t)s.Lz * sizeof(T),
                                 (cuuint64_t)s.Ly * s.Lz * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)w.W, (cuuint32_t)w.BY, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, sizeof(T) == 4   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
           : sizeof(T) == 8 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT64
                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<T*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The ring in dynamic shared memory: R slots of nf boxes, `extra` boxes,
// then one mbarrier per slot (initialised here: every thread of the block
// constructs it, and the constructor ends in a __syncthreads).
template <typename T, int R = kRing>
struct PlaneRing {
  T* buf;
  uint64_t* full;
  int box, nf;
  unsigned tx_bytes;  // what one plane's copies deliver: nf boxes of W x BY

  __device__ PlaneRing(unsigned char* raw, const TmaWindow& w, int nf_,
                       int extra)
      : box(w.box), nf(nf_),
        tx_bytes((unsigned)(nf_ * w.W * w.BY * (int)sizeof(T))) {
    unsigned char* base = raw + ((128u - (smem_addr(raw) & 127u)) & 127u);
    buf = reinterpret_cast<T*>(base);
    full = reinterpret_cast<uint64_t*>(buf + (R * nf + extra) * box);
    if (threadIdx.x == 0) {
      for (int i = 0; i < R; ++i) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                         smem_addr(full + i))
                     : "memory");
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  // the nf boxes of plane use i (field-major)
  __device__ __forceinline__ T* slot(int i) const {
    return buf + (i % R) * nf * box;
  }
  __device__ __forceinline__ T* extra(int j) const {
    return buf + (R * nf + j) * box;
  }
  // the first byte after the ring's barriers (8-byte aligned)
  __device__ __forceinline__ unsigned char* end() const {
    return reinterpret_cast<unsigned char*>(full + R);
  }

  // Thread 0 only: start the copies of plane g, the box at (zs, ys), of the
  // nf maps maps[0..nf) into the slot of use i.
  __device__ __forceinline__ void fetch(int i, const CUtensorMap* const* maps,
                                        int zs, int ys, int g) const {
    const unsigned bar = smem_addr(full + i % R);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     bar),
                 "r"(tx_bytes)
                 : "memory");
    for (int f = 0; f < nf; ++f) {
      asm volatile(
          "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
          "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
              smem_addr(slot(i) + f * box)),
          "l"(maps[f]), "r"(bar), "r"(zs), "r"(ys), "r"(g)
          : "memory");
    }
  }
  __device__ __forceinline__ void fetch(int i, const CUtensorMap* m0,
                                        const CUtensorMap* m1, int zs, int ys,
                                        int g) const {
    const CUtensorMap* maps[2] = {m0, m1};
    fetch(i, maps, zs, ys, g);
  }

  // Wait until the copies of use i have landed.
  __device__ __forceinline__ void wait(int i) const {
    const unsigned bar = smem_addr(full + i % R);
    const unsigned parity = (unsigned)(i / R) & 1u;
    asm volatile(
        "{\n .reg .pred P1;\n WAIT:\n"
        " mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        " @!P1 bra WAIT;\n}\n" ::"r"(bar),
        "r"(parity)
        : "memory");
  }
};

}  // namespace wave
