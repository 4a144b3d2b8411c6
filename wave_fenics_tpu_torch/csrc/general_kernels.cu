// Hand-written Hopper kernel K of the explicit-dofmap operators (sm_90a).
//
// Kernel K replaces the TPU kernel wave_fenics_tpu/ops/pallas_general.py::
// _kernel -> _kernel_sub -> _window_contrib (:185/:241/:301) and its
// VMEM-resident variant _kernel_resident (:582), built by make_general_apply
// (:654) and make_general_call (:899). It computes the matvec of an operator
// on an explicit dofmap (imported or unstructured hex meshes),
//
//   y = coeff S(E(x_e)),   x_e[c, n] = x[dofmap[c, n]],
//
// with S the scatter-add over the dofmap and E the element operator of one
// of four modes (ops/general.py builds the tables):
//
//   mass             detJw .* x_e at the collocated GLL points;
//   stiffness        sum_{d,d'} D_d^T (G_dd' .* D_d' x_e), the six symmetric
//                    G entries per node, or G = g6[c] w_q for affine cells;
//   mass_gauss       B^T diag(detJw_q) B x_e at non-collocated points;
//   stiffness_gauss  the full-G stiffness at non-collocated points.
//
// The TPU kernel's window and chain tables, gather overflow, scatter merge
// and spill path exist because Mosaic has no scattered loads
// (pallas_general.py:22-24, 72-86, 311-318). Hopper gathers natively, so
// none of them is here.
//
// The scatter is a coloured, in-place accumulation: the cells are split
// into colours so that no two cells of one colour share a dof
// (ops/gather_scatter.py::colour_cells, built once on the host), y is set
// to 0, and one launch per colour, in a fixed order, adds its cells'
// coeff E(x_e) straight into y (bf16: into a float32 workspace, below). No
// atomics: each dof's sum is (((0 + first colour's term) + next) + ...),
// the same bit for bit on every run (the JAX package's determinism,
// tests/test_determinism.py).
//
// general_stiffness_kernel<T, M, Affine> (the collocated stiffness, the
// mode of the general solvers, m = M = p + 1 <= 7): one thread per (j, k)
// column of a cell, CPB = kColumnThreads / M^2 cells per block (10 at
// p = 4), no division per entry. A thread issues the loads of its column's
// dofmap entries, its 6M geometry values and then its x gather before the
// block's first barrier, so the geometry's latency overlaps the gather's;
// the column's M values of x_e stay in registers (the i derivative and its
// transpose never touch shared memory), the j and k derivatives read one
// shared copy of the cell, and w1, w2 of the transpose go through shared
// memory. The streamed tables (geometry, dofmap) are loaded with the
// evict-first hint, so x and y stay in L2.
// general_element_kernel<T, Mode, Affine> (mass, mass_gauss,
// stiffness_gauss): a block owns `cpb` cells, gathers x_e into shared
// memory, applies the sum-factorized 1D contractions with B and D and adds
// coeff y_e into y; the collocated mass is one thread per element entry.
// In both, the colour launches overlap (programmatic dependent launch): a
// launch's blocks start on the SMs the previous colour's last blocks free,
// load and contract their cells, and wait (griddepcontrol.wait) only before
// they read and write y.
//
// What bounds it on this card: per cell and contraction m multiply-adds per
// point, far below the flop rate; the compulsory traffic is x and y once,
// the dofmap and the geometry (6 values per node for the per-node
// stiffness: at 64x32x32 cells, p = 4, f32, 17.1 + 17.1 + 32.8 + 196.6 MB,
// 0.079 ms at 3.35 TB/s; bf16 8.55 + 8.55 + 32.8 + 98.3 MB, 0.0442 ms).
// The design adds the pass that sets y to 0 (general_zero_kernel) and the
// read of the y entries that each colour updates, L2 hits while y stays
// resident.
//
// bf16 state (T = __nv_bfloat16): x, B, D, the geometry (and w) are bf16,
// the dofmap int32; every load widens to float32 (Acc<T>,
// stencil_tiled.cuh), the cell buffers in shared memory and all the
// arithmetic are float32. The colours do not add into the bf16 y: a
// rounding per colour of a partial sum would cost the stiffness, whose
// element terms cancel almost wholly, most of its relative accuracy. They
// add into a float32 workspace of ndofs instead (the caller's `work`; the
// zero pass clears it), and a last pass (general_round_kernel) rounds it
// once into y. The sum order stays fixed, so a bf16 apply is bitwise
// repeatable too. The workspace costs 4 bytes a dof (17.1 MB at the size
// above), written by the zero pass, updated in L2 by the colours and read
// once by the last pass: about 43 MB of traffic more than the bf16 bound.
// f32 and f64 accumulate in y itself (work is y).
//
// The extern "C" launcher returns cudaGetLastError() after its launches (or
// the error of a call before them), so the caller sees a launch that the
// runtime refused.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "stencil_tiled.cuh"

namespace wave_general {

using wave::Acc;
using wave::narrow;
using wave::widen;

constexpr int kThreads = 128;        // general_element_kernel
constexpr int kColumnThreads = 256;  // general_stiffness_kernel, at most

enum Mode { kMass = 0, kStiffness = 1, kMassGauss = 2, kStiffnessGauss = 3 };

// Cells a block of the column kernel takes: one thread per (j, k) column.
template <int M>
__host__ __device__ constexpr int column_cells() {
  return kColumnThreads / (M * M) > 0 ? kColumnThreads / (M * M) : 1;
}

// Column-kernel blocks an SM must hold: two in f32 and bf16 (128
// registers a thread), one in f64.
template <typename T>
__host__ __device__ constexpr int column_min_blocks() {
  return sizeof(Acc<T>) == 4 ? 2 : 1;
}

template <typename T>
struct ElementArgs {
  using A = Acc<T>;
  const T* x;           // [ndofs]
  A* y;                 // [ndofs], accumulated in place (bf16: the workspace)
  const int* dofmap;    // [nc, m^3]
  const int* cells;     // this launch's cells: one colour's
  int ncells;           // cells in this launch
  const T* B;           // [nq, m]
  const T* D;           // [nq, m]
  const T* geo;         // [ngeo, nc, npts], or [ngeo, nc] for affine cells
  const T* w;           // [npts] (affine cells only)
  int m, nq, nc;
  int cpb;              // cells per block (general_element_kernel)
  int stride;           // shared-memory elements per cell (the same)
  A coeff;
};

// Programmatic dependent launch: the next launch on the stream may start
// its blocks now, on the SMs this launch frees...
__device__ __forceinline__ void allow_next_launch() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// ... and this block waits here until the previous launch on the stream
// has ended and its writes (y) are visible.
__device__ __forceinline__ void wait_previous_launch() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// The geometric factor `g` of `cell` at point `q` (npts points per cell).
template <typename T, bool Affine>
__device__ __forceinline__ Acc<T> geo_at(const ElementArgs<T>& a, int g, int cell,
                                         int q, int npts) {
  if (Affine) return widen(a.geo[(long long)g * a.nc + cell]) * widen(a.w[q]);
  return widen(a.geo[((long long)g * a.nc + cell) * npts + q]);
}

// ---------------------------------------------------------------------------
// The collocated stiffness, one thread per (j, k) column.
// ---------------------------------------------------------------------------

// The six G entries of the column's M nodes (node i at entry i M^2 + col of
// the cell), in registers.
template <typename T, int M, bool Affine>
__device__ __forceinline__ void load_geometry(const ElementArgs<T>& a, int cell,
                                              int col, Acc<T> (&g)[6][M]) {
  constexpr int M2 = M * M, M3 = M2 * M;
  if (Affine) {
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      const Acc<T> ge = widen(__ldg(&a.geo[(long long)e * a.nc + cell]));
#pragma unroll
      for (int i = 0; i < M; ++i) g[e][i] = ge * widen(__ldg(&a.w[i * M2 + col]));
    }
  } else {
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      const T* ge = a.geo + ((long long)e * a.nc + cell) * M3 + col;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        g[e][i] = widen(__ldcs(ge + i * M2));  // streamed: evict first
      }
    }
  }
}

template <typename T, int M, bool Affine>
__global__ void __launch_bounds__(kColumnThreads, (column_min_blocks<T>()))
    general_stiffness_kernel(ElementArgs<T> a) {
  using A = Acc<T>;
  constexpr int M2 = M * M, M3 = M2 * M, CPB = column_cells<M>();
  __shared__ A sD[M2];
  __shared__ A xs[CPB][M3];   // the cells' x_e
  __shared__ A w1s[CPB][M3];  // w_1 = G_1. grad x_e
  __shared__ A w2s[CPB][M3];  // w_2 = G_2. grad x_e
  const int tid = (int)threadIdx.x;
  const int lc = tid / M2;  // the block's cell of this thread
  const int col = tid - lc * M2;
  const int j = col / M;
  const int k = col - j * M;
  const int slot = (int)blockIdx.x * CPB + lc;
  const bool live = slot < a.ncells;
  if (tid < M2) sD[tid] = widen(a.D[tid]);

  int dof[M];
  A g[6][M], xc[M];
  if (live) {
    const int cell = __ldg(&a.cells[slot]);
    const int* dm = a.dofmap + (long long)cell * M3 + col;
#pragma unroll
    for (int i = 0; i < M; ++i) dof[i] = __ldcs(dm + i * M2);  // streamed: evict first
    load_geometry<T, M, Affine>(a, cell, col, g);
#pragma unroll
    for (int i = 0; i < M; ++i) xc[i] = widen(__ldg(&a.x[dof[i]]));
  } else {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      dof[i] = 0;
      xc[i] = A(0);
#pragma unroll
      for (int e = 0; e < 6; ++e) g[e][i] = A(0);
    }
  }
  // the next colour's blocks load and contract their cells while this
  // launch ends
  allow_next_launch();
#pragma unroll
  for (int i = 0; i < M; ++i) xs[lc][i * M2 + col] = xc[i];
  __syncthreads();

  // per node (i, j, k): the reference gradient u, then w_d = sum_d' G_dd' u_d'
  const A* xe = xs[lc];
  A w0[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    A u0 = A(0), u1 = A(0), u2 = A(0);
#pragma unroll
    for (int s = 0; s < M; ++s) {
      u0 += sD[i * M + s] * xc[s];
      u1 += sD[j * M + s] * xe[(i * M + s) * M + k];
      u2 += sD[k * M + s] * xe[(i * M + j) * M + s];
    }
    w0[i] = g[0][i] * u0 + g[1][i] * u1 + g[2][i] * u2;
    w1s[lc][i * M2 + col] = g[1][i] * u0 + g[3][i] * u1 + g[4][i] * u2;
    w2s[lc][i * M2 + col] = g[2][i] * u0 + g[4][i] * u1 + g[5][i] * u2;
  }
  __syncthreads();

  // y_e = sum_d D_d^T w_d
  const A* w1 = w1s[lc];
  const A* w2 = w2s[lc];
  A acc[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    acc[i] = A(0);
#pragma unroll
    for (int s = 0; s < M; ++s) acc[i] += sD[s * M + i] * w0[s];
#pragma unroll
    for (int s = 0; s < M; ++s) acc[i] += sD[s * M + j] * w1[(i * M + s) * M + k];
#pragma unroll
    for (int s = 0; s < M; ++s) acc[i] += sD[s * M + k] * w2[(i * M + j) * M + s];
  }
  // added into y once the previous launch (the previous colour, or the
  // pass that set y to 0) has ended
  wait_previous_launch();
  if (!live) return;
  A yo[M];
#pragma unroll
  for (int i = 0; i < M; ++i) yo[i] = a.y[dof[i]];
#pragma unroll
  for (int i = 0; i < M; ++i) a.y[dof[i]] = yo[i] + a.coeff * acc[i];
}

// ---------------------------------------------------------------------------
// The other modes: one block of `cpb` cells, sum-factorized in shared memory.
// ---------------------------------------------------------------------------

// One 1D contraction of every cell tensor of the block along Axis (T: the
// arithmetic type):
// out[.., o, ..] = sum_k M(o, k) in[.., k, ..], with the table M [rows, cols]
// row-major in shared memory, M(o, k) = M[o][k], or M[k][o] when Trans.
// `in` has dims (n0, n1, n2); `out` the same with dims[Axis] -> nout.
template <typename T, int Axis, bool Trans, bool Accum>
__device__ void contract(const T* in, T* out, int stride, int ncell, int n0,
                         int n1, int n2, const T* M, int cols, int nout) {
  const int nk = Axis == 0 ? n0 : (Axis == 1 ? n1 : n2);
  const int o0n = Axis == 0 ? nout : n0;
  const int o1n = Axis == 1 ? nout : n1;
  const int o2n = Axis == 2 ? nout : n2;
  const int per = o0n * o1n * o2n;
  const int step = Axis == 0 ? n1 * n2 : (Axis == 1 ? n2 : 1);
  for (int e = threadIdx.x; e < ncell * per; e += blockDim.x) {
    const int c = e / per;
    const int r = e - c * per;
    const int o0 = r / (o1n * o2n);
    const int o1 = (r / o2n) % o1n;
    const int o2 = r % o2n;
    const int o = Axis == 0 ? o0 : (Axis == 1 ? o1 : o2);
    const int i0 = Axis == 0 ? 0 : o0;
    const int i1 = Axis == 1 ? 0 : o1;
    const int i2 = Axis == 2 ? 0 : o2;
    const T* src = in + c * stride + (i0 * n1 + i1) * n2 + i2;
    T acc = T(0);
    for (int k = 0; k < nk; ++k) {
      const T coef = Trans ? M[k * cols + o] : M[o * cols + k];
      acc += coef * src[k * step];
    }
    T* dst = out + c * stride + r;
    if (Accum) {
      *dst += acc;
    } else {
      *dst = acc;
    }
  }
}

template <typename T, int Mode, bool Affine>
__global__ void __launch_bounds__(kThreads)
    general_element_kernel(ElementArgs<T> a) {
  using A = Acc<T>;
  extern __shared__ unsigned char smem_raw[];
  A* buf = reinterpret_cast<A*>(smem_raw);
  const int m = a.m, nq = a.nq;
  const int nd = m * m * m;
  const int slot0 = blockIdx.x * a.cpb;  // the block's first cell of the launch
  const int ncell = min(a.cpb, a.ncells - slot0);
  const int tid = threadIdx.x;
  allow_next_launch();

  if (Mode == kMass) {  // y += coeff detJw .* x_e, one thread per entry
    for (int e0 = 0; e0 < ncell * nd; e0 += blockDim.x) {
      const int e = e0 + tid;
      int d = 0;
      A ye = A(0);
      if (e < ncell * nd) {
        const int cell = a.cells[slot0 + e / nd];
        const int n = e % nd;
        d = a.dofmap[(long long)cell * nd + n];
        ye = a.coeff * (widen(a.x[d]) * geo_at<T, Affine>(a, 0, cell, n, nd));
      }
      wait_previous_launch();
      if (e < ncell * nd) a.y[d] += ye;
    }
    return;
  }

  // tables B and D after the cells' buffers
  A* sB = buf + a.cpb * a.stride;
  A* sD = sB + nq * m;
  for (int e = tid; e < nq * m; e += blockDim.x) {
    sB[e] = widen(a.B[e]);
    sD[e] = widen(a.D[e]);
  }
  // gather x_e into each cell's first nd elements
  for (int e = tid; e < a.cpb * nd; e += blockDim.x) {
    const int c = e / nd;
    const int n = e - c * nd;
    buf[c * a.stride + n] =
        c < ncell ? widen(a.x[a.dofmap[(long long)a.cells[slot0 + c] * nd + n]]) : A(0);
  }
  __syncthreads();

  // per cell, x_e (reused as the output accumulator) [m^3], g0..g2 [Q^3]
  // each, t1, t2 [Q^3] each, Q = max(m, nq)
  const int Q = m > nq ? m : nq;
  const int Q3 = Q * Q * Q;
  const int nq3 = nq * nq * nq;
  const int S = a.stride;
  A* xe = buf;
  A* g = buf + nd;  // g_d at g + d * Q3
  A* t1 = g + 3 * Q3;
  A* t2 = t1 + Q3;

  if (Mode == kMassGauss) {
    contract<A, 0, false, false>(xe, t1, S, ncell, m, m, m, sB, m, nq);
    __syncthreads();
    contract<A, 1, false, false>(t1, t2, S, ncell, nq, m, m, sB, m, nq);
    __syncthreads();
    contract<A, 2, false, false>(t2, g, S, ncell, nq, nq, m, sB, m, nq);
    __syncthreads();
    for (int e = tid; e < ncell * nq3; e += blockDim.x) {
      const int c = e / nq3;
      const int q = e - c * nq3;
      g[c * S + q] *= geo_at<T, false>(a, 0, a.cells[slot0 + c], q, nq3);
    }
    __syncthreads();
    contract<A, 0, true, false>(g, t1, S, ncell, nq, nq, nq, sB, m, m);
    __syncthreads();
    contract<A, 1, true, false>(t1, t2, S, ncell, m, nq, nq, sB, m, m);
    __syncthreads();
    contract<A, 2, true, false>(t2, xe, S, ncell, m, m, nq, sB, m, m);
    __syncthreads();
  } else {  // kStiffnessGauss
    // g_d = grad_d x_e: D on axis d, B on the others
    for (int d = 0; d < 3; ++d) {
      A* gd = g + d * Q3;
      contract<A, 0, false, false>(xe, t1, S, ncell, m, m, m, d == 0 ? sD : sB, m, nq);
      __syncthreads();
      contract<A, 1, false, false>(t1, t2, S, ncell, nq, m, m, d == 1 ? sD : sB, m, nq);
      __syncthreads();
      contract<A, 2, false, false>(t2, gd, S, ncell, nq, nq, m, d == 2 ? sD : sB, m, nq);
      __syncthreads();
    }
    // w = G g at every point, in place
    for (int e = tid; e < ncell * nq3; e += blockDim.x) {
      const int c = e / nq3;
      const int q = e - c * nq3;
      const int cell = a.cells[slot0 + c];
      A* p0 = g + c * S + q;
      const A u0 = p0[0], u1 = p0[Q3], u2 = p0[2 * Q3];
      const A g00 = geo_at<T, false>(a, 0, cell, q, nq3);
      const A g01 = geo_at<T, false>(a, 1, cell, q, nq3);
      const A g02 = geo_at<T, false>(a, 2, cell, q, nq3);
      const A g11 = geo_at<T, false>(a, 3, cell, q, nq3);
      const A g12 = geo_at<T, false>(a, 4, cell, q, nq3);
      const A g22 = geo_at<T, false>(a, 5, cell, q, nq3);
      p0[0] = g00 * u0 + g01 * u1 + g02 * u2;
      p0[Q3] = g01 * u0 + g11 * u1 + g12 * u2;
      p0[2 * Q3] = g02 * u0 + g12 * u1 + g22 * u2;
    }
    __syncthreads();
    // y = sum_d grad_d^T w_d, accumulated in x_e's buffer
    for (int d = 0; d < 3; ++d) {
      const A* gd = g + d * Q3;
      contract<A, 0, true, false>(gd, t1, S, ncell, nq, nq, nq, d == 0 ? sD : sB, m, m);
      __syncthreads();
      contract<A, 1, true, false>(t1, t2, S, ncell, m, nq, nq, d == 1 ? sD : sB, m, m);
      __syncthreads();
      if (d == 0) {
        contract<A, 2, true, false>(t2, xe, S, ncell, m, m, nq, sB, m, m);
      } else {
        contract<A, 2, true, true>(t2, xe, S, ncell, m, m, nq, d == 2 ? sD : sB, m, m);
      }
      __syncthreads();
    }
  }
  wait_previous_launch();
  for (int e = tid; e < ncell * nd; e += blockDim.x) {
    const int c = e / nd;
    const int n = e - c * nd;
    const int d = a.dofmap[(long long)a.cells[slot0 + c] * nd + n];
    a.y[d] += a.coeff * buf[c * S + n];
  }
}

// ---------------------------------------------------------------------------
// Launchers: y = 0, then one launch per colour.
// ---------------------------------------------------------------------------

// y = 0 (the accumulator: y, or bf16's workspace), 16 bytes a store where
// y's base allows; colour 0's blocks may start their loads meanwhile (they
// wait for this launch before they touch y). Launched as an ordinary
// kernel: it starts only when the work before it on the stream, which may
// read y, has ended.
template <typename T>
__global__ void __launch_bounds__(256) general_zero_kernel(T* __restrict__ y, int n) {
  allow_next_launch();
  const int start = blockIdx.x * blockDim.x + threadIdx.x;
  const int step = gridDim.x * blockDim.x;
  constexpr int kPer = 16 / (int)sizeof(T);
  const int nv = (reinterpret_cast<uintptr_t>(y) % 16 == 0) ? n / kPer : 0;
  int4* yv = reinterpret_cast<int4*>(y);
  for (int i = start; i < nv; i += step) yv[i] = make_int4(0, 0, 0, 0);
  for (int i = nv * kPer + start; i < n; i += step) y[i] = T(0);
}

// bf16: y = the float32 workspace rounded once (an ordinary launch: it
// starts when the last colour has ended).
template <typename T>
__global__ void __launch_bounds__(256)
    general_round_kernel(const Acc<T>* __restrict__ work, T* __restrict__ y, int n) {
  const int step = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    y[i] = narrow<T>(work[i]);
  }
}

// A colour's launch may begin while the previous launch on the stream
// finishes (programmatic dependent launch): its blocks load and contract
// their cells, then wait for the previous launch's y.
template <typename T>
int launch_overlapped(void (*kernel)(ElementArgs<T>), unsigned blocks, int threads,
                      int smem, const ElementArgs<T>& a, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <typename T, int M, bool Affine>
int launch_stiffness_colour(const ElementArgs<T>& a, cudaStream_t stream) {
  constexpr int CPB = column_cells<M>();
  return launch_overlapped<T>(general_stiffness_kernel<T, M, Affine>,
                              (unsigned)((a.ncells + CPB - 1) / CPB), CPB * M * M, 0, a,
                              stream);
}

template <typename T, bool Affine>
int launch_stiffness(const ElementArgs<T>& a, cudaStream_t stream) {
  switch (a.m) {
    case 2: return launch_stiffness_colour<T, 2, Affine>(a, stream);
    case 3: return launch_stiffness_colour<T, 3, Affine>(a, stream);
    case 4: return launch_stiffness_colour<T, 4, Affine>(a, stream);
    case 5: return launch_stiffness_colour<T, 5, Affine>(a, stream);
    case 6: return launch_stiffness_colour<T, 6, Affine>(a, stream);
    case 7: return launch_stiffness_colour<T, 7, Affine>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int Mode, bool Affine>
int launch_element(const ElementArgs<T>& a, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        general_element_kernel<T, Mode, Affine>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  return launch_overlapped<T>(general_element_kernel<T, Mode, Affine>,
                              (unsigned)((a.ncells + a.cpb - 1) / a.cpb), kThreads, smem,
                              a, stream);
}

template <typename T>
int launch_colour(const ElementArgs<T>& a, int mode, int affine, int smem,
                  cudaStream_t stream) {
  if (mode == kStiffness) {
    return affine ? launch_stiffness<T, true>(a, stream)
                  : launch_stiffness<T, false>(a, stream);
  }
  if (mode == kMass) {
    return affine ? launch_element<T, kMass, true>(a, smem, stream)
                  : launch_element<T, kMass, false>(a, smem, stream);
  }
  if (mode == kMassGauss && !affine) {
    return launch_element<T, kMassGauss, false>(a, smem, stream);
  }
  if (mode == kStiffnessGauss && !affine) {
    return launch_element<T, kStiffnessGauss, false>(a, smem, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// colour_starts is a host array [ncolours + 1]: colour c's cells are
// cells[colour_starts[c] .. colour_starts[c + 1]). `work` is the
// accumulator: y itself in f32 and f64, a float32 buffer of ndofs for bf16.
template <typename T>
int launch_general_apply(const T* x, T* y, void* work, const int* dofmap,
                         const int* cells, const int* colour_starts, int ncolours,
                         const T* B, const T* D, const T* geo, const T* w,
                         int mode, int affine, int m, int nq, int nc, int ndofs,
                         int cpb, int stride, int smem, double coeff,
                         cudaStream_t stream) {
  using A = Acc<T>;
  constexpr bool kWorkspace = !std::is_same<T, A>::value;
  A* acc = static_cast<A*>(work);
  if ((mode == kStiffness && (m < 2 || m > 7)) || acc == nullptr ||
      (kWorkspace ? work == (void*)y || work == (const void*)x : work != (void*)y)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto blocks = [](long long n) {
    return (unsigned)(n < 65535LL * 64 ? n : 65535LL * 64);
  };
  general_zero_kernel<A><<<blocks((ndofs / (16 / (long long)sizeof(A)) + 255LL) / 256 + 1),
                           256, 0, stream>>>(acc, ndofs);
  for (int c = 0; c < ncolours; ++c) {
    const int n = colour_starts[c + 1] - colour_starts[c];
    if (n <= 0) continue;
    const ElementArgs<T> a{x, acc, dofmap, cells + colour_starts[c], n, B, D, geo,
                           w, m, nq, nc, cpb, stride, A(coeff)};
    const int rc = launch_colour<T>(a, mode, affine, smem, stream);
    if (rc != 0) return rc;
  }
  if constexpr (kWorkspace) {
    general_round_kernel<T><<<blocks((ndofs + 255LL) / 256), 256, 0, stream>>>(acc, y,
                                                                              ndofs);
  }
  return (int)cudaGetLastError();
}

}  // namespace wave_general

// ---------------------------------------------------------------------------
// Plain C interface (bound with ctypes by ops/_cuda.py).
// ---------------------------------------------------------------------------

#define WAVE_GENERAL_DEFINE_LAUNCHER(T, SUFFIX)                                 \
  extern "C" int wave_general_apply_##SUFFIX(                                   \
      const T* x, T* y, void* work, const int* dofmap, const int* cells,        \
      const int* colour_starts, int ncolours, const T* B, const T* D,           \
      const T* geo, const T* w, int mode, int affine, int m, int nq, int nc,    \
      int ndofs, int cpb, int stride, int smem, double coeff,                   \
      cudaStream_t stream) {                                                    \
    return wave_general::launch_general_apply<T>(                               \
        x, y, work, dofmap, cells, colour_starts, ncolours, B, D, geo, w, mode, \
        affine, m, nq, nc, ndofs, cpb, stride, smem, coeff, stream);            \
  }

WAVE_GENERAL_DEFINE_LAUNCHER(float, f32)
WAVE_GENERAL_DEFINE_LAUNCHER(double, f64)
WAVE_GENERAL_DEFINE_LAUNCHER(__nv_bfloat16, bf16)
