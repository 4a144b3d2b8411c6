// Hand-written Hopper kernels of the general-mesh set-up (sm_90a): the
// geometry factors, the quantized node keys and the dof dedup.
//
// They are the port's counterpart of the JAX package's host library
// wave_fenics_tpu/native/wavecore.cpp (geometry_factors :32, dedup_dofs
// :87), which stands in for the reference's host precompute
// (common/precomputation.hpp:18-110) and DOLFINx's dofmap construction.
// native.py wraps them; core/geometry.py, core/dofmap.py,
// models/general_wave.py::facet_lumped_weights and ops/operators.py::
// GeneralOperators call them for a model built on a CUDA device.
//
// geometry_factors_kernel: one thread per (cell, quadrature point), f64.
//   J[i][j] = sum_n (X[c, n, i] - X[c, 0, i]) dphi[j, q, n], summed over the
//   8 vertices in basix order as wavecore's loop does, on the coordinates
//   relative to vertex 0 (each row of dphi sums to exactly 0, so this is
//   the same J; wavecore's absolute coordinates lose about |X| / h ulps to
//   cancellation: 5e-15 relative in detJw on a cut of the P8 model, 2 mm
//   cells up to 0.13 m from the origin, against 5e-16 here); det J, the
//   adjugate inverse K
//   (wavecore's formula), G = K K^T |det J| w_q and detJw = |det J| w_q;
//   then, when asked, clamp_table's snap to -1, 0, 1 (core/basis.py: the
//   test |g - v| <= 1e-8 + 1e-5 |v| of np.isclose, v in that order). A
//   block takes a tile of QT points and walks kCellPasses passes of CB
//   cells: the tile's dphi is loaded once into shared memory as [3][8][QT]
//   (consecutive points in consecutive words, no bank conflicts), each
//   pass's 24 coordinates a cell beside it, and each pass's G is staged in
//   shared memory, then written as one contiguous run a cell (a thread's 9
//   words are 72 bytes apart in G's layout). A zero determinant sets
//   *singular; the wrapper raises.
//   Bound: bytes. It writes 10 doubles a point (655 MB at the P8 model,
//   0.20 ms at 3.35 TB/s) against about 250 f64 operations a point.
//
// node_keys_kernel: one thread per (cell, node). x = sum_v phi[n, v]
//   X[c, v], key = rint(x * inv) as int64 (inv = 1 / (scale tol), the
//   product of core/dofmap.py::build_dofmap). The eight products of a
//   component are sorted by value (a 19-comparator network) and summed in
//   that order, which does not depend on how the cell lists its vertices:
//   two cells that share a node and list its face in different orders sum
//   the same products in the same order, so the node gets one key even
//   where x lies at a key's .5 boundary (a sum in vertex order, or BLAS's,
//   can round the two copies apart there). Every product and sum is
//   rounded on its own (__dmul_rn, __dadd_rn: no fused multiply-add), so
//   the kernel and its plain version agree bit for bit.
//   Bound: bytes (6 words written a node).
//
// dedup_insert_kernel, dedup_lookup_kernel: the counterpart of wavecore's
//   std::unordered_map pass, an open-addressed table of 2^k >= 2n slots
//   (linear probing), hashed by wavecore's FNV-1a over the three int64
//   words and then murmur3's fmix64 finalizer (the slot is the hash's low
//   bits; unordered_map takes the hash modulo a prime, and FNV-1a's low
//   bits depend only on the keys' low bits, which quantized coordinates
//   share). A slot holds the flat index of a node that owns its key. Insert:
//   a node claims an empty slot with atomicCAS, or finds the slot of its key
//   and atomicMin's its own index into it, so every slot ends at its key's
//   first appearance whatever the order the threads run in. Lookup: each
//   node reads its key's slot, rep[i] = the first appearance. The wrapper
//   numbers the dofs by an exclusive scan of (rep[i] == i) taken at rep:
//   the first-appearance numbering of wavecore's serial loop, independent
//   of thread order. A probe that runs through the whole table sets
//   *overflow; the wrapper raises.
//   Bound: bytes (the keys in, the ids out; the table's traffic is the
//   design's own).
//
// Every index is int64: at 64^3 cells and p = 10, nc (p+1)^3 reaches
// 3.5e8 nodes. The extern "C" launchers return cudaGetLastError() after
// their launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace wave_setup {

constexpr int kThreads = 256;
constexpr int kCellPasses = 8;  // cell groups a geometry block walks
constexpr unsigned long long kEmpty = ~0ull;

__device__ __forceinline__ double clamp_value(double g) {
  if (fabs(g + 1.0) <= 1e-8 + 1e-5 * 1.0) return -1.0;
  if (fabs(g) <= 1e-8) return 0.0;
  if (fabs(g - 1.0) <= 1e-8 + 1e-5 * 1.0) return 1.0;
  return g;
}

__global__ void __launch_bounds__(kThreads)
    geometry_factors_kernel(const double* __restrict__ X,
                            const double* __restrict__ dphi,
                            const double* __restrict__ w, int64_t nc, int nq,
                            int qt, int cb, int clamp, double* __restrict__ G,
                            double* __restrict__ detJw,
                            int* __restrict__ singular) {
  extern __shared__ double smem[];
  double* sd = smem;           // [3][8][qt]: the tile's dphi
  double* sx = sd + 24 * qt;   // [cb][8][3]: a pass's cells
  double* sg = sx + 24 * cb;   // [cb][qt][9]: a pass's G, written out coalesced
  const int q0 = blockIdx.y * qt;
  const int nqt = min(qt, nq - q0);
  for (int t = threadIdx.x; t < 24 * qt; t += blockDim.x) {
    const int jn = t / qt, ql = t % qt;  // jn = j * 8 + n
    sd[t] = ql < nqt ? dphi[((int64_t)(jn / 8) * nq + q0 + ql) * 8 + jn % 8] : 0.0;
  }
  const int cl = threadIdx.x / qt, ql = threadIdx.x % qt;
  const double wq = ql < nqt ? w[q0 + ql] : 0.0;
  for (int pass = 0; pass < kCellPasses; ++pass) {
    const int64_t c0 = ((int64_t)blockIdx.x * kCellPasses + pass) * cb;
    if (c0 >= nc) break;  // the same for every thread of the block
    __syncthreads();      // the tile is in; the last pass's sx and sg are read
    for (int t = threadIdx.x; t < 24 * cb; t += blockDim.x)
      sx[t] = c0 + t / 24 < nc ? X[c0 * 24 + t] : 0.0;
    __syncthreads();
    const int64_t c = c0 + cl;
    if (ql < nqt && c < nc) {
      const double* x = sx + cl * 24;
      double J[3][3] = {{0.0, 0.0, 0.0}, {0.0, 0.0, 0.0}, {0.0, 0.0, 0.0}};
#pragma unroll
      for (int n = 1; n < 8; ++n) {  // vertex 0's relative coordinates are 0
        const double x0 = x[n * 3 + 0] - x[0], x1 = x[n * 3 + 1] - x[1],
                     x2 = x[n * 3 + 2] - x[2];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const double d = sd[(j * 8 + n) * qt + ql];
          J[0][j] += x0 * d;
          J[1][j] += x1 * d;
          J[2][j] += x2 * d;
        }
      }
      const double det = J[0][0] * (J[1][1] * J[2][2] - J[1][2] * J[2][1]) -
                         J[0][1] * (J[1][0] * J[2][2] - J[1][2] * J[2][0]) +
                         J[0][2] * (J[1][0] * J[2][1] - J[1][1] * J[2][0]);
      if (det == 0.0) atomicExch(singular, 1);
      const double inv = det == 0.0 ? 0.0 : 1.0 / det;
      double K[3][3];  // J^-1 = adj(J) / det
      K[0][0] = (J[1][1] * J[2][2] - J[1][2] * J[2][1]) * inv;
      K[0][1] = (J[0][2] * J[2][1] - J[0][1] * J[2][2]) * inv;
      K[0][2] = (J[0][1] * J[1][2] - J[0][2] * J[1][1]) * inv;
      K[1][0] = (J[1][2] * J[2][0] - J[1][0] * J[2][2]) * inv;
      K[1][1] = (J[0][0] * J[2][2] - J[0][2] * J[2][0]) * inv;
      K[1][2] = (J[0][2] * J[1][0] - J[0][0] * J[1][2]) * inv;
      K[2][0] = (J[1][0] * J[2][1] - J[1][1] * J[2][0]) * inv;
      K[2][1] = (J[0][1] * J[2][0] - J[0][0] * J[2][1]) * inv;
      K[2][2] = (J[0][0] * J[1][1] - J[0][1] * J[1][0]) * inv;
      const double dw = fabs(det) * wq;
      detJw[c * nq + q0 + ql] = dw;
      double* g = sg + (cl * qt + ql) * 9;
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const double v =
              dw * (K[i][0] * K[j][0] + K[i][1] * K[j][1] + K[i][2] * K[j][2]);
          g[i * 3 + j] = clamp ? clamp_value(v) : v;
        }
    }
    __syncthreads();
    // each cell's G of the tile is one contiguous run of nqt * 9 words
    const int ncl = (int)min((int64_t)cb, nc - c0), run = nqt * 9;
    for (int t = threadIdx.x; t < ncl * run; t += blockDim.x) {
      const int k = t / run, r = t % run;
      G[((c0 + k) * nq + q0) * 9 + r] = sg[k * qt * 9 + r];
    }
  }
}

// a <= b afterwards; equal values (+0 and -0 among them) stay as they are
__device__ __forceinline__ void order2(double& a, double& b) {
  const bool swap = b < a;
  const double lo = swap ? b : a, hi = swap ? a : b;
  a = lo;
  b = hi;
}

__global__ void __launch_bounds__(kThreads)
    node_keys_kernel(const double* __restrict__ X,
                     const double* __restrict__ phi, int64_t nc, int nd,
                     double inv, long long* __restrict__ keys,
                     double* __restrict__ coords) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nc * nd) return;
  const double* x = X + (t / nd) * 24;
  const double* f = phi + (t % nd) * 8;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    double s[8];
#pragma unroll
    for (int v = 0; v < 8; ++v) s[v] = __dmul_rn(f[v], x[v * 3 + i]);
    // a 19-comparator sorting network for 8 values
    order2(s[0], s[2]); order2(s[1], s[3]); order2(s[4], s[6]); order2(s[5], s[7]);
    order2(s[0], s[4]); order2(s[1], s[5]); order2(s[2], s[6]); order2(s[3], s[7]);
    order2(s[0], s[1]); order2(s[2], s[3]); order2(s[4], s[5]); order2(s[6], s[7]);
    order2(s[2], s[4]); order2(s[3], s[5]);
    order2(s[1], s[4]); order2(s[3], s[6]);
    order2(s[1], s[2]); order2(s[3], s[4]); order2(s[5], s[6]);
    double acc = s[0];
#pragma unroll
    for (int v = 1; v < 8; ++v) acc = __dadd_rn(acc, s[v]);
    coords[t * 3 + i] = acc;
    keys[t * 3 + i] = (long long)rint(__dmul_rn(acc, inv));
  }
}

__device__ __forceinline__ unsigned long long key_hash(long long k0,
                                                       long long k1,
                                                       long long k2) {
  unsigned long long h = 1469598103934665603ull;  // FNV-1a, wavecore :88-96
  h ^= (unsigned long long)k0;
  h *= 1099511628211ull;
  h ^= (unsigned long long)k1;
  h *= 1099511628211ull;
  h ^= (unsigned long long)k2;
  h *= 1099511628211ull;
  h ^= h >> 33;  // murmur3 fmix64
  h *= 0xff51afd7ed558ccdull;
  h ^= h >> 33;
  h *= 0xc4ceb9fe1a85ec53ull;
  h ^= h >> 33;
  return h;
}

__device__ __forceinline__ bool same_key(const long long* __restrict__ keys,
                                         unsigned long long j, long long k0,
                                         long long k1, long long k2) {
  return keys[j * 3] == k0 && keys[j * 3 + 1] == k1 && keys[j * 3 + 2] == k2;
}

__global__ void __launch_bounds__(kThreads)
    dedup_insert_kernel(const long long* __restrict__ keys, int64_t n,
                        unsigned long long* table, unsigned long long mask,
                        int* __restrict__ overflow) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long k0 = keys[i * 3], k1 = keys[i * 3 + 1], k2 = keys[i * 3 + 2];
  unsigned long long s = key_hash(k0, k1, k2) & mask;
  for (unsigned long long probe = 0; probe <= mask; ++probe, s = (s + 1) & mask) {
    unsigned long long cur = table[s];
    if (cur == kEmpty) {
      cur = atomicCAS(table + s, kEmpty, (unsigned long long)i);
      if (cur == kEmpty) return;  // claimed: i is the first of its key so far
    }
    // cur is a node of the slot's key (a slot's value only ever moves to a
    // smaller index of the same key)
    if (same_key(keys, cur, k0, k1, k2)) {
      atomicMin(table + s, (unsigned long long)i);
      return;
    }
  }
  atomicExch(overflow, 1);
}

__global__ void __launch_bounds__(kThreads)
    dedup_lookup_kernel(const long long* __restrict__ keys, int64_t n,
                        const unsigned long long* __restrict__ table,
                        unsigned long long mask, long long* __restrict__ rep,
                        int* __restrict__ overflow) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long k0 = keys[i * 3], k1 = keys[i * 3 + 1], k2 = keys[i * 3 + 2];
  unsigned long long s = key_hash(k0, k1, k2) & mask;
  for (unsigned long long probe = 0; probe <= mask; ++probe, s = (s + 1) & mask) {
    const unsigned long long cur = table[s];
    if (cur == kEmpty) break;
    if (same_key(keys, cur, k0, k1, k2)) {
      rep[i] = (long long)cur;
      return;
    }
  }
  atomicExch(overflow, 1);
}

inline unsigned int blocks_for(int64_t n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace wave_setup

// G [nc, nq, 9] and detJw [nc, nq] of the cells X [nc, 8, 3] with the
// coordinate-basis gradients dphi [3, nq, 8] and weights w [nq]; a block
// takes a tile of qt points and kCellPasses passes of cb cells (qt cb <= 256
// threads), smem = 24 (qt + cb) + 9 qt cb doubles
// (native.py::geometry_launch_shape).
extern "C" int wave_geometry_factors(const double* X, const double* dphi,
                                     const double* w, int64_t nc, int nq,
                                     int qt, int cb, int clamp, double* G,
                                     double* detJw, int* singular, int smem,
                                     cudaStream_t stream) {
  if (nc <= 0) return (int)cudaGetLastError();
  const int64_t per_block = (int64_t)cb * wave_setup::kCellPasses;
  const dim3 grid((unsigned int)((nc + per_block - 1) / per_block),
                  (unsigned int)((nq + qt - 1) / qt));
  wave_setup::geometry_factors_kernel<<<grid, qt * cb, smem, stream>>>(
      X, dphi, w, nc, nq, qt, cb, clamp, G, detJw, singular);
  return (int)cudaGetLastError();
}

// keys [nc nd, 3] int64 and coords [nc nd, 3] of the nodes phi [nd, 8] of
// the cells X [nc, 8, 3], key = rint(x inv).
extern "C" int wave_node_keys(const double* X, const double* phi, int64_t nc,
                              int nd, double inv, long long* keys,
                              double* coords, cudaStream_t stream) {
  const int64_t n = nc * nd;
  if (n <= 0) return (int)cudaGetLastError();
  wave_setup::node_keys_kernel<<<wave_setup::blocks_for(n),
                                 wave_setup::kThreads, 0, stream>>>(
      X, phi, nc, nd, inv, keys, coords);
  return (int)cudaGetLastError();
}

// rep [n] = the first flat index of each node's key among keys [n, 3];
// table [mask + 1] filled with ~0 by the caller (mask + 1 a power of two
// >= 2n); *overflow set where a probe found no slot.
extern "C" int wave_dedup_hash(const long long* keys, int64_t n,
                               unsigned long long* table,
                               unsigned long long mask, long long* rep,
                               int* overflow, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const unsigned int blocks = wave_setup::blocks_for(n);
  wave_setup::dedup_insert_kernel<<<blocks, wave_setup::kThreads, 0, stream>>>(
      keys, n, table, mask, overflow);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  wave_setup::dedup_lookup_kernel<<<blocks, wave_setup::kThreads, 0, stream>>>(
      keys, n, table, mask, rep, overflow);
  return (int)cudaGetLastError();
}
