// Kernels A and C on Hopper (sm_90a): one classic RK4 step as four launches
// of rk4_tiled_kernel<T, P, J>, one per stage J = 0..3, on the 2.5D tiled
// stencil of stencil_tiled.cuh.
//
// * The lean stage algebra (kernel A) replaces
//   wave_fenics_tpu/ops/pallas_rk4step.py::_kernel_rk4_step_lean.
// * The full Butcher tableau (kernel C, the argument lean = 0) replaces
//   pallas_rk4step.py::_kernel_rk4_step; kernel J (rk42_tiled.cu) runs
//   six of its stages.
//
// What bounds them on this card: with one multiply-add per tap the flops
// are far below the H100's rate; the compulsory traffic of a step's four
// launches is the interiors of the fields stage J reads (1 to 5; their
// padding is 0), 11 in all, and the padded kv_J, or u1 and v1, it writes,
// 5 in all: about 0.104 ms at 3.35 TB/s in f32 at the P1 size. The earlier
// per-point form loaded every tap from L1/L2 and formed the stage input
// from two or three fields at each of the 3(2p + 1) taps: it was bound by
// load issue at 7x that floor.
//
// The design: a block streams one x-chunk of a ty x tz tile of interior
// columns (stencil_tiled.cuh). Each x plane of the fields the stage input
// needs is fetched once, by cp.async into a ring of kPipe planes, up to
// kPipe - 1 planes ahead of the one being computed; the stage input un_J is
// formed once per point in shared memory, by the thread that copied the
// point, before the plane's one barrier (0 outside the interior, exactly
// what the zero padding gave); the y/z taps are read from shared memory, the x taps
// from a register queue of 2p + 1 values, and the column's y/z tables sit
// in registers. The y/z sum of a plane waits p planes in a second register
// queue until its x taps have arrived. P is a template parameter (p = 1..8)
// so both queues are registers. The blocks also write the zero padding of
// every output, whatever it held before. No tensor cores: the tap
// coefficients change per point, and TF32 would break the f32 gates.
//
// With kv_J = A un_J + face terms and a = dt/2,
//
//   lean (A)                          full tableau (C)
//   un0 = u0                          un0 = u0
//   un1 = u0 + a v0                   un1 = u0 + a v0
//   un2 = un1 + dt^2/4 kv0            un2 = u0 + a (v0 + a kv0)
//   un3 = (u0 + dt v0) + dt^2/2 kv1   un3 = u0 + dt (v0 + a kv1)
//
// and vn0 = v0, vn1 = v0 + a kv0, vn2 = v0 + a kv1, vn3 = v0 + dt kv2 in
// both. Stages 0..2 write kv_J; stage 3 writes (u1, v1):
//
//   lean: u1 = (u0 + dt v0) + dt^2/6 (kv0 + kv1 + kv2)
//         v1 = v0 + dt/6 (kv0 + 2 kv1 + 2 kv2 + kv3)
//   full: u1 = u0 + dt (((b0 v0 + b1 vn1) + b2 vn2) + b3 vn3)
//         v1 = v0 + dt (((b0 kv0 + b1 kv1) + b2 kv2) + b3 kv3)
//
// each in its TPU kernel's association order. The face terms act on rows
// src_x and abc_x only, in the TPU kernels' order: the stencil, then the
// source c0^2 g_J W1, then the absorbing term -c0 W2 vn_J. Stage 3 reads
// u0's neighbours while it writes u1, so no output may alias an input.
//
// On a value-halo layout (halo >= 2p deep, holding the neighbour blocks'
// values: parallel/sharded_padded.py) the caller passes each stage's box
// grown by its ring r_J into the halo and load = p: stages 0 and 1 write
// kv0, kv1 to depth p (stage 2 reads kv0, stage 3 kv1, at their taps),
// stages 2 and 3 the interior only, since a step's result at a point
// depends on (u0, v0) within 2p of it. The kernel is the same: it writes
// its box and zeros outside it, and reads the load ring as it is in memory.
//
// bf16 state (T = __nv_bfloat16; f32 and f64 take the same code with
// Acc<T> = T): the fields and tables are bf16, the arithmetic float32
// (stencil_tiled.cuh::Acc), dt, g and the c0 terms float32 (the TPU
// kernel rounds them to the state dtype, pallas_rk4step.py:554). A stage
// input is rounded once where it is stored in the ring, kv0..kv2 and (u1,
// v1) where they are written; the planes are copied in pairs (cp.async
// takes 4 bytes at least), so tz and h - p must be even.
//
// Each extern "C" launcher returns cudaGetLastError() after its launch (or
// cudaErrorInvalidValue for a tiling that does not fit the layout).

#include <cuda_runtime.h>

#include "stencil_tiled.cuh"

namespace wave {

template <typename T>
struct StageArgs {
  const T* u0;
  const T* v0;
  const T* kv0;
  const T* kv1;
  const T* kv2;
  T* kv_out;  // stages 0..2
  T* u1;      // stage 3
  T* v1;      // stage 3
  const T* w1;  // [F] source facet weights / m
  const T* w2;  // [F] absorbing facet weights / m
  int src_x, abc_x;
  int lean;  // 1: kernel A's stage algebra; 0: kernel C's
  int load;  // the load ring around the output box (Window)
  Acc<T> dt, g, c0sq, mc0;  // in the arithmetic type: f32 for bf16 state
};

// Fields whose plane values form the stage input: u0, v0 and kv0 (J = 2)
// or kv1 (J = 3).
template <int J>
__host__ __device__ constexpr int stage_fields() {
  return J == 0 ? 1 : J == 1 ? 2 : 3;
}

template <typename A, int J>
__device__ __forceinline__ A stage_input(A u0, A v0, A k, bool lean, A dt) {
  const A half = A(0.5);
  if constexpr (J == 1) {
    return u0 + (half * dt) * v0;
  } else if constexpr (J == 2) {
    return lean ? (u0 + (half * dt) * v0) + (A(0.25) * (dt * dt)) * k
                : u0 + (half * dt) * (v0 + (half * dt) * k);
  } else {
    return lean ? (u0 + dt * v0) + (half * (dt * dt)) * k
                : u0 + dt * (v0 + (half * dt) * k);
  }
}

// Blocks per SM the register budget must allow: four at p <= 4 in f32 and
// bf16 (64 registers a thread), else what the compiler needs. (bf16 on
// f64's one block took 0.72 ms/step at the P1 layout, on f32's rule 0.54,
// no spills; PERF.md section 6.)
template <typename T, int P>
__host__ __device__ constexpr int min_blocks() {
  return sizeof(T) <= 4 && P <= 4 ? 4 : 1;
}

template <typename T, int P, int J>
__global__ void __launch_bounds__(kTileThreads, (min_blocks<T, P>()))
    rk4_tiled_kernel(Stencil<T> s, StageArgs<T> a, Tiling t) {
  using A = Acc<T>;
  constexpr int K = 2 * P + 1;
  constexpr int NF = stage_fields<J>();
  constexpr int V = copy_width<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const TileCoords c(s, t);
  const int plane = (t.ty + 2 * P) * (t.tz + 2 * P);
  const Window<P, V> w(s, c, t,
                       reinterpret_cast<int*>(smem + kPipe * NF * plane),
                       a.load);
  const int W = w.W;
  const int F = s.F();
  const A dt = a.dt;
  const A half = A(0.5);
  const bool lean = a.lean != 0;
  const T* kin = J == 2 ? a.kv0 : a.kv1;

  ColumnTables<T, P> tab;
  tab.load(s, c.f, c.active);
  A q[K];  // q[k] = un_J at row gi - 2P + k after plane gi
#pragma unroll
  for (int k = 0; k < K; ++k) q[k] = A(0);
  A yzq[P];  // yzq[j] = the y/z sum at row gi - P + 1 + j after plane gi
#pragma unroll
  for (int j = 0; j < P; ++j) yzq[j] = A(0);

  const int iters = c.xe - c.xs + 2 * P;  // planes xs - P .. xe + P - 1
#pragma unroll
  for (int i = 0; i < kPipe - 1; ++i) {
    if (i < iters) {
      fetch_plane<T, P, NF>(smem + i * NF * plane, a.u0, a.v0, kin, s, w,
                            c.xs - P + i);
    }
    cp_async_commit();
  }
  if constexpr (J < 3) {  // while the first planes are in flight
    zero_padding<T>(s, t, a.kv_out, nullptr);
  } else {
    zero_padding<T>(s, t, a.u1, a.v1);
  }

  for (int i = 0; i < iters; ++i) {
    const int gi = c.xs - P + i;
    T* buf = smem + (i % kPipe) * NF * plane;
    cp_async_wait<kPipe - 2>();  // this thread's copies of plane gi landed
    if constexpr (J > 0) {  // un_J once per point, in place of u0, by the
                            // thread that copied the point (V points a copy),
                            // stored in T: bf16 rounds it here
      for (int e0 = V * (int)threadIdx.x; e0 < plane; e0 += V * w.nt) {
#pragma unroll
        for (int e = e0; e < e0 + V; ++e) {
          buf[e] = narrow<T>(stage_input<A, J>(
              widen(buf[e]), widen(buf[plane + e]),
              NF > 2 ? widen(buf[2 * plane + e]) : A(0), lean, dt));
        }
      }
    }
    __syncthreads();  // plane gi is complete; slot (i - 1) % kPipe is free
    const int ip = i + kPipe - 1;
    if (ip < iters) {
      fetch_plane<T, P, NF>(smem + (ip % kPipe) * NF * plane, a.u0, a.v0, kin,
                            s, w, c.xs - P + ip);
    }
    cp_async_commit();

    const T* ctr = buf + (c.ly + P) * W + (c.lz + P);
#pragma unroll
    for (int k = 0; k < K - 1; ++k) q[k] = q[k + 1];
    q[K - 1] = widen(ctr[0]);
    const A yz_new = gi >= c.xs && gi < c.xe ? tab.yz(ctr, W) : A(0);
    const A yz = yzq[0];
#pragma unroll
    for (int j = 0; j < P - 1; ++j) yzq[j] = yzq[j + 1];
    yzq[P - 1] = yz_new;

    if (i < 2 * P || !c.active) continue;
    const int g = gi - P;  // the output row
    const long long idx = (long long)g * F + c.f;
    A kv = x_taps<A, P>(s, q, g) * tab.fx + yz * widen(__ldg(&s.sx[g]));
    if (g == a.src_x) kv += (a.c0sq * a.g) * widen(a.w1[c.f]);
    if (g == a.abc_x) {
      A vn;
      if constexpr (J == 0) {
        vn = widen(a.v0[idx]);
      } else if constexpr (J == 1) {
        vn = widen(a.v0[idx]) + (half * dt) * widen(a.kv0[idx]);
      } else if constexpr (J == 2) {
        vn = widen(a.v0[idx]) + (half * dt) * widen(a.kv1[idx]);
      } else {
        vn = widen(a.v0[idx]) + dt * widen(a.kv2[idx]);
      }
      kv += (a.mc0 * widen(a.w2[c.f])) * vn;
    }
    if constexpr (J < 3) {
      a.kv_out[idx] = narrow<T>(kv);
    } else if (lean) {
      const A dt2 = dt * dt;
      const A v0 = widen(a.v0[idx]);
      const A k1 = widen(a.kv1[idx]);
      const A k2 = widen(a.kv2[idx]);
      const A s2 = (widen(a.kv0[idx]) + k1) + k2;
      a.u1[idx] = narrow<T>((widen(a.u0[idx]) + dt * v0) + (dt2 / A(6)) * s2);
      a.v1[idx] = narrow<T>(v0 + (dt / A(6)) * (((s2 + k1) + k2) + kv));
    } else {
      const A b0 = A(1.0 / 6.0);
      const A b1 = A(1.0 / 3.0);
      const A v0 = widen(a.v0[idx]);
      const A k0 = widen(a.kv0[idx]);
      const A k1 = widen(a.kv1[idx]);
      const A k2 = widen(a.kv2[idx]);
      const A vn1 = v0 + (half * dt) * k0;
      const A vn2 = v0 + (half * dt) * k1;
      const A vn3 = v0 + dt * k2;
      const A accu = ((b0 * v0 + b1 * vn1) + b1 * vn2) + b0 * vn3;
      const A accv = ((b0 * k0 + b1 * k1) + b1 * k2) + b0 * kv;
      a.u1[idx] = narrow<T>(widen(a.u0[idx]) + dt * accu);
      a.v1[idx] = narrow<T>(v0 + dt * accv);
    }
  }
  cp_async_wait<0>();
}

template <typename T, int P, int J>
int launch_stage(Stencil<T> s, StageArgs<T> a, Tiling t, dim3 grid, int smem,
                 cudaStream_t stream) {
  if (smem < tiled_smem_bytes<T, P>(t, stage_fields<J>())) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = rk4_tiled_kernel<T, P, J>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, t.ty * t.tz, smem, stream>>>(s, a, t);
  return (int)cudaGetLastError();
}

template <typename T, int P>
int launch_stage_p(int stage, Stencil<T> s, StageArgs<T> a, Tiling t,
                   dim3 grid, int smem, cudaStream_t stream) {
  switch (stage) {
    case 0: return launch_stage<T, P, 0>(s, a, t, grid, smem, stream);
    case 1: return launch_stage<T, P, 1>(s, a, t, grid, smem, stream);
    case 2: return launch_stage<T, P, 2>(s, a, t, grid, smem, stream);
    case 3: return launch_stage<T, P, 3>(s, a, t, grid, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_rk4_tiled(int stage, Stencil<T> s, StageArgs<T> a, Tiling t,
                     dim3 grid, int smem, cudaStream_t stream) {
  // bf16 pairs (fetch_plane): tz and h - p even, so every pair lies in one
  // row and starts 4-byte aligned
  if (copy_width<T>() == 2 && (t.tz % 2 != 0 || (s.h - s.p) % 2 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  if (!tiling_fits(t, grid, s.nx, s.ny, s.nz) || !box_fits_int(s) ||
      a.load < 0 || s.x0 - a.load < 0 || s.x0 + s.nx + a.load > s.Lx ||
      s.h - a.load < 0 || s.h + s.ny + a.load > s.Ly ||
      s.h + s.nz + a.load > s.Lz) {
    return (int)cudaErrorInvalidValue;
  }
  switch (s.p) {
    case 1: return launch_stage_p<T, 1>(stage, s, a, t, grid, smem, stream);
    case 2: return launch_stage_p<T, 2>(stage, s, a, t, grid, smem, stream);
    case 3: return launch_stage_p<T, 3>(stage, s, a, t, grid, smem, stream);
    case 4: return launch_stage_p<T, 4>(stage, s, a, t, grid, smem, stream);
    case 5: return launch_stage_p<T, 5>(stage, s, a, t, grid, smem, stream);
    case 6: return launch_stage_p<T, 6>(stage, s, a, t, grid, smem, stream);
    case 7: return launch_stage_p<T, 7>(stage, s, a, t, grid, smem, stream);
    case 8: return launch_stage_p<T, 8>(stage, s, a, t, grid, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace wave

// ---------------------------------------------------------------------------
// Plain C interface (bound with ctypes by ops/_cuda.py). (x0, nx, h, ny,
// nz) is the output box: the interior, or on a value-halo layout the
// interior grown into the halo by the stage's ring; `load` is the ring of
// values read around it (0: the interior only). The last seven ints are
// ops/tiling.py::tiled_geometry's tiling of the box: ty, tz, cx, the grid
// (gx, gy, gz) and the dynamic shared memory in bytes.
// ---------------------------------------------------------------------------

#define WAVE_DEFINE_RK4_STAGE(T, SUFFIX, NAME, LEAN)                          \
  extern "C" int NAME##_##SUFFIX(                                             \
      int stage, const T* u0, const T* v0, const T* kv0, const T* kv1,        \
      const T* kv2, T* kv_out, T* u1, T* v1, const T* w1, const T* w2,        \
      int src_x, int abc_x, double dt, double g, double c0, const T* cvx,     \
      const T* sx, const T* fx, const T* cvy, const T* cvz, int p, int Lx,    \
      int Ly, int Lz, int x0, int nx, int h, int ny, int nz, int load,        \
      int ty, int tz, int cx, int gx, int gy, int gz, int smem,               \
      cudaStream_t stream) {                                                  \
    using A = wave::Acc<T>;                                                   \
    wave::StageArgs<T> a{u0, v0, kv0, kv1, kv2, kv_out, u1, v1, w1, w2,       \
                         src_x, abc_x, LEAN, load, (A)dt, (A)g,               \
                         (A)(c0 * c0), (A)(-c0)};                             \
    wave::Stencil<T> s{cvx, sx, fx, cvy, cvz, p, Lx, Ly, Lz,                  \
                       x0, nx, h, ny, nz};                                    \
    return wave::launch_rk4_tiled<T>(stage, s, a, wave::Tiling{ty, tz, cx},   \
                                     dim3(gx, gy, gz), smem, stream);         \
  }

WAVE_DEFINE_RK4_STAGE(float, f32, wave_rk4_stage, 1)
WAVE_DEFINE_RK4_STAGE(double, f64, wave_rk4_stage, 1)
WAVE_DEFINE_RK4_STAGE(float, f32, wave_rk4_full_stage, 0)
WAVE_DEFINE_RK4_STAGE(double, f64, wave_rk4_full_stage, 0)
WAVE_DEFINE_RK4_STAGE(__nv_bfloat16, bf16, wave_rk4_stage, 1)
WAVE_DEFINE_RK4_STAGE(__nv_bfloat16, bf16, wave_rk4_full_stage, 0)
