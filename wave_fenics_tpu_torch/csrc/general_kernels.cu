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
// Two launches per apply, and no atomics, so the result is the same bit for
// bit on every run (the JAX package's determinism, tests/test_determinism.py):
//
// 1. general_element_kernel: a block owns `cpb` cells. It gathers each
//    cell's x_e into shared memory through the cell's dofmap row, applies
//    the 1D contractions with B and D (sum-factorized: O(m^4) work per cell,
//    no dense nd x nq table), folds in the geometry and coeff, applies the
//    transposes and writes ye[c, :] to a workspace. The collocated mass
//    needs no shared memory: one thread per element entry.
// 2. general_scatter_kernel: one thread per dof sums that dof's sources
//    ye[order[k]], k in [starts[d], starts[d+1]), in that fixed order
//    (ops/gather_scatter.py::build_scatter_csr).
//
// What bounds it on this card: per cell and contraction m multiply-adds per
// point, 3(m^4) to 18(max(m, nq)^4) in all, are far below the flop rate;
// the compulsory traffic is x and y once, the dofmap and the geometry
// (6 values per node for the per-node stiffness: at 64x32x32 cells, p = 4,
// f32, 17.1 + 17.1 + 32.8 + 196.6 MB). This first form also writes and reads
// the workspace and reads the scatter tables (about 115 MB more), and its
// gathers of x hit L2 where neighbouring cells share dofs.
//
// Each extern "C" launcher returns cudaGetLastError() after its launches (or
// the error of the attribute call before them), so the caller sees a launch
// that the runtime refused.

#include <cuda_runtime.h>

namespace wave_general {

constexpr int kThreads = 128;

enum Mode { kMass = 0, kStiffness = 1, kMassGauss = 2, kStiffnessGauss = 3 };

template <typename T>
struct ElementArgs {
  const T* x;           // [ndofs]
  T* ye;                // [nc, m^3] workspace
  const int* dofmap;    // [nc, m^3]
  const T* B;           // [nq, m]
  const T* D;           // [nq, m]
  const T* geo;         // [ngeo, nc, npts], or [ngeo, nc] for affine cells
  const T* w;           // [npts] (affine cells only)
  int m, nq, nc;
  int cpb;              // cells per block
  int stride;           // shared-memory elements per cell
  T coeff;
};

// The geometric factor `g` of `cell` at point `q` (npts points per cell).
template <typename T, bool Affine>
__device__ __forceinline__ T geo_at(const ElementArgs<T>& a, int g, int cell,
                                    int q, int npts) {
  if (Affine) return a.geo[(long long)g * a.nc + cell] * a.w[q];
  return a.geo[((long long)g * a.nc + cell) * npts + q];
}

// One 1D contraction of every cell tensor of the block along Axis:
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
  extern __shared__ unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);
  const int m = a.m, nq = a.nq;
  const int nd = m * m * m;
  const int cell0 = blockIdx.x * a.cpb;
  const int ncell = min(a.cpb, a.nc - cell0);
  const int tid = threadIdx.x;

  if (Mode == kMass) {  // y_e = coeff detJw .* x_e, one thread per entry
    for (int e = tid; e < ncell * nd; e += blockDim.x) {
      const int cell = cell0 + e / nd;
      const int n = e % nd;
      const long long idx = (long long)cell * nd + n;
      a.ye[idx] = a.coeff * (a.x[a.dofmap[idx]] * geo_at<T, Affine>(a, 0, cell, n, nd));
    }
    return;
  }

  // tables B and D after the cells' buffers
  T* sB = buf + a.cpb * a.stride;
  T* sD = sB + nq * m;
  for (int e = tid; e < nq * m; e += blockDim.x) {
    sB[e] = a.B[e];
    sD[e] = a.D[e];
  }
  // gather x_e into each cell's first nd elements
  for (int e = tid; e < a.cpb * nd; e += blockDim.x) {
    const int c = e / nd;
    const int n = e - c * nd;
    buf[c * a.stride + n] =
        c < ncell ? a.x[a.dofmap[(long long)(cell0 + c) * nd + n]] : T(0);
  }
  __syncthreads();

  if (Mode == kStiffness) {
    // collocated: B = I. Per node, the three reference derivatives, then
    // w_d = sum_d' G_dd' u_d' (into the cell's buffers 1..3)
    for (int e = tid; e < ncell * nd; e += blockDim.x) {
      const int c = e / nd;
      const int n = e - c * nd;
      const int i = n / (m * m);
      const int j = (n / m) % m;
      const int k = n % m;
      const T* xe = buf + c * a.stride;
      T u0 = T(0), u1 = T(0), u2 = T(0);
      for (int s = 0; s < m; ++s) {
        u0 += sD[i * m + s] * xe[(s * m + j) * m + k];
        u1 += sD[j * m + s] * xe[(i * m + s) * m + k];
        u2 += sD[k * m + s] * xe[(i * m + j) * m + s];
      }
      const int cell = cell0 + c;
      const T g00 = geo_at<T, Affine>(a, 0, cell, n, nd);
      const T g01 = geo_at<T, Affine>(a, 1, cell, n, nd);
      const T g02 = geo_at<T, Affine>(a, 2, cell, n, nd);
      const T g11 = geo_at<T, Affine>(a, 3, cell, n, nd);
      const T g12 = geo_at<T, Affine>(a, 4, cell, n, nd);
      const T g22 = geo_at<T, Affine>(a, 5, cell, n, nd);
      T* wv = buf + c * a.stride + nd;
      wv[n] = g00 * u0 + g01 * u1 + g02 * u2;
      wv[nd + n] = g01 * u0 + g11 * u1 + g12 * u2;
      wv[2 * nd + n] = g02 * u0 + g12 * u1 + g22 * u2;
    }
    __syncthreads();
    // y = sum_d D_d^T w_d
    for (int e = tid; e < ncell * nd; e += blockDim.x) {
      const int c = e / nd;
      const int n = e - c * nd;
      const int i = n / (m * m);
      const int j = (n / m) % m;
      const int k = n % m;
      const T* w0 = buf + c * a.stride + nd;
      const T* w1 = w0 + nd;
      const T* w2 = w1 + nd;
      T acc = T(0);
      for (int s = 0; s < m; ++s) acc += sD[s * m + i] * w0[(s * m + j) * m + k];
      for (int s = 0; s < m; ++s) acc += sD[s * m + j] * w1[(i * m + s) * m + k];
      for (int s = 0; s < m; ++s) acc += sD[s * m + k] * w2[(i * m + j) * m + s];
      a.ye[(long long)(cell0 + c) * nd + n] = a.coeff * acc;
    }
    return;
  }

  // non-collocated modes: per cell, x_e (reused as the output accumulator)
  // [m^3], g0..g2 [Q^3] each, t1, t2 [Q^3] each, Q = max(m, nq)
  const int Q = m > nq ? m : nq;
  const int Q3 = Q * Q * Q;
  const int nq3 = nq * nq * nq;
  const int S = a.stride;
  T* xe = buf;
  T* g = buf + nd;  // g_d at g + d * Q3
  T* t1 = g + 3 * Q3;
  T* t2 = t1 + Q3;

  if (Mode == kMassGauss) {
    contract<T, 0, false, false>(xe, t1, S, ncell, m, m, m, sB, m, nq);
    __syncthreads();
    contract<T, 1, false, false>(t1, t2, S, ncell, nq, m, m, sB, m, nq);
    __syncthreads();
    contract<T, 2, false, false>(t2, g, S, ncell, nq, nq, m, sB, m, nq);
    __syncthreads();
    for (int e = tid; e < ncell * nq3; e += blockDim.x) {
      const int c = e / nq3;
      const int q = e - c * nq3;
      g[c * S + q] *= geo_at<T, false>(a, 0, cell0 + c, q, nq3);
    }
    __syncthreads();
    contract<T, 0, true, false>(g, t1, S, ncell, nq, nq, nq, sB, m, m);
    __syncthreads();
    contract<T, 1, true, false>(t1, t2, S, ncell, m, nq, nq, sB, m, m);
    __syncthreads();
    contract<T, 2, true, false>(t2, xe, S, ncell, m, m, nq, sB, m, m);
    __syncthreads();
  } else {  // kStiffnessGauss
    // g_d = grad_d x_e: D on axis d, B on the others
    for (int d = 0; d < 3; ++d) {
      T* gd = g + d * Q3;
      contract<T, 0, false, false>(xe, t1, S, ncell, m, m, m, d == 0 ? sD : sB, m, nq);
      __syncthreads();
      contract<T, 1, false, false>(t1, t2, S, ncell, nq, m, m, d == 1 ? sD : sB, m, nq);
      __syncthreads();
      contract<T, 2, false, false>(t2, gd, S, ncell, nq, nq, m, d == 2 ? sD : sB, m, nq);
      __syncthreads();
    }
    // w = G g at every point, in place
    for (int e = tid; e < ncell * nq3; e += blockDim.x) {
      const int c = e / nq3;
      const int q = e - c * nq3;
      const int cell = cell0 + c;
      T* p0 = g + c * S + q;
      const T u0 = p0[0], u1 = p0[Q3], u2 = p0[2 * Q3];
      const T g00 = geo_at<T, false>(a, 0, cell, q, nq3);
      const T g01 = geo_at<T, false>(a, 1, cell, q, nq3);
      const T g02 = geo_at<T, false>(a, 2, cell, q, nq3);
      const T g11 = geo_at<T, false>(a, 3, cell, q, nq3);
      const T g12 = geo_at<T, false>(a, 4, cell, q, nq3);
      const T g22 = geo_at<T, false>(a, 5, cell, q, nq3);
      p0[0] = g00 * u0 + g01 * u1 + g02 * u2;
      p0[Q3] = g01 * u0 + g11 * u1 + g12 * u2;
      p0[2 * Q3] = g02 * u0 + g12 * u1 + g22 * u2;
    }
    __syncthreads();
    // y = sum_d grad_d^T w_d, accumulated in x_e's buffer
    for (int d = 0; d < 3; ++d) {
      const T* gd = g + d * Q3;
      contract<T, 0, true, false>(gd, t1, S, ncell, nq, nq, nq, d == 0 ? sD : sB, m, m);
      __syncthreads();
      contract<T, 1, true, false>(t1, t2, S, ncell, m, nq, nq, d == 1 ? sD : sB, m, m);
      __syncthreads();
      if (d == 0) {
        contract<T, 2, true, false>(t2, xe, S, ncell, m, m, nq, sB, m, m);
      } else {
        contract<T, 2, true, true>(t2, xe, S, ncell, m, m, nq, d == 2 ? sD : sB, m, m);
      }
      __syncthreads();
    }
  }
  for (int e = tid; e < ncell * nd; e += blockDim.x) {
    const int c = e / nd;
    const int n = e - c * nd;
    a.ye[(long long)(cell0 + c) * nd + n] = a.coeff * buf[c * S + n];
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
    general_scatter_kernel(const T* __restrict__ ye, const int* __restrict__ order,
                           const int* __restrict__ starts, T* __restrict__ y,
                           int ndofs) {
  for (int d = blockIdx.x * blockDim.x + threadIdx.x; d < ndofs;
       d += gridDim.x * blockDim.x) {
    const int lo = starts[d], hi = starts[d + 1];
    T acc = T(0);
    for (int k = lo; k < hi; ++k) acc += ye[order[k]];
    y[d] = acc;
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
  const unsigned blocks = (unsigned)((a.nc + a.cpb - 1) / a.cpb);
  general_element_kernel<T, Mode, Affine><<<blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_general_apply(const T* x, T* y, T* ye, const int* dofmap,
                         const int* order, const int* starts, const T* B,
                         const T* D, const T* geo, const T* w, int mode,
                         int affine, int m, int nq, int nc, int ndofs, int cpb,
                         int stride, int smem, double coeff,
                         cudaStream_t stream) {
  ElementArgs<T> a{x, ye, dofmap, B, D, geo, w, m, nq, nc, cpb, stride, T(coeff)};
  int rc;
  if (mode == kMass) {
    rc = affine ? launch_element<T, kMass, true>(a, smem, stream)
                : launch_element<T, kMass, false>(a, smem, stream);
  } else if (mode == kStiffness) {
    rc = affine ? launch_element<T, kStiffness, true>(a, smem, stream)
                : launch_element<T, kStiffness, false>(a, smem, stream);
  } else if (mode == kMassGauss && !affine) {
    rc = launch_element<T, kMassGauss, false>(a, smem, stream);
  } else if (mode == kStiffnessGauss && !affine) {
    rc = launch_element<T, kStiffnessGauss, false>(a, smem, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  const long long nb = (ndofs + 255LL) / 256;
  general_scatter_kernel<T><<<(unsigned)(nb < 65535LL * 64 ? nb : 65535LL * 64), 256,
                              0, stream>>>(ye, order, starts, y, ndofs);
  return (int)cudaGetLastError();
}

}  // namespace wave_general

// ---------------------------------------------------------------------------
// Plain C interface (bound with ctypes by ops/_cuda.py).
// ---------------------------------------------------------------------------

#define WAVE_GENERAL_DEFINE_LAUNCHER(T, SUFFIX)                                 \
  extern "C" int wave_general_apply_##SUFFIX(                                   \
      const T* x, T* y, T* ye, const int* dofmap, const int* order,             \
      const int* starts, const T* B, const T* D, const T* geo, const T* w,      \
      int mode, int affine, int m, int nq, int nc, int ndofs, int cpb,          \
      int stride, int smem, double coeff, cudaStream_t stream) {                \
    return wave_general::launch_general_apply<T>(                               \
        x, y, ye, dofmap, order, starts, B, D, geo, w, mode, affine, m, nq, nc, \
        ndofs, cpb, stride, smem, coeff, stream);                               \
  }

WAVE_GENERAL_DEFINE_LAUNCHER(float, f32)
WAVE_GENERAL_DEFINE_LAUNCHER(double, f64)
