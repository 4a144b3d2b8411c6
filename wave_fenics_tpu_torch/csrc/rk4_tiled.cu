// Kernels A and C on Hopper (sm_90a): one classic RK4 step as four launches
// of rk4_tiled_kernel<T, P, J>, one per stage J = 0..3, on the 2.5D tiled
// stencil of stencil_tiled.cuh with TMA plane loads.
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
// 5 in all: about 0.104 ms at 3.35 TB/s in f32 at the P1 size. The first
// tiled form copied each plane element by element with cp.async, formed
// the stage input in a second pass over the plane, read stage 3's five
// point-wise fields in the plane that needed them and had every tile block
// write its share of the padding first: 74 % of its time was that data
// movement, not the taps. This form is all data movement too: with the
// stencil replaced by the point value a step takes as long (PERF.md
// section 6).
//
// The design (kernel D's, rk_stage_tiled.cu): a block owns a ty x tz tile
// of interior (y, z) columns and streams one x-chunk with p warm-up planes
// on each side. Each plane's windows of the NF fields the stage input
// needs (stage_fields: u0; u0, v0; u0, v0, kv0; u0, v0, kv1), the tile and
// its p-deep y/z halo, arrive by one TMA request a field into a ring of
// stage_ring<NF>() planes, the ring's depth less one ahead. Stages 1..3
// form un_J once per point of the window's (ty + 2p) x (tz + 2p) halo box
// into one of two stage-input planes, each thread its points nt apart
// (found by steps, not by a division a point: the division took 12 and 18
// of stages 1's and 2's 92 and 111 us at P1), before the plane's one
// barrier; stage 0 reads u0's window as it is. The
// x taps come from a register queue of the column's last 2p + 1 un_J
// values, the y/z taps from the plane, the column's y/z tables and its W1,
// W2 entries sit in registers, and a plane's y/z sum waits p planes in a
// second register queue. The point-wise fields of the output row (stage 3:
// u0, v0, kv0, kv1, kv2; stages 0..2: v0 and the kv of vn_J, on the
// absorbing row only) are loaded a plane ahead, so that their latency
// hides behind a plane's work. The outputs' padding is written by layers
// of padding blocks beside the tile blocks (padding_block, zero_padding;
// as many layers as put two padding blocks on every SM, since a block's
// stores go only as fast as its SM issues them), the grid's first where
// the tile blocks take more than one wave of the card's block slots, else
// its last (tiling.tma_padding_first, as kernels H and I). P is a template
// parameter (p = 1..8); the launch bounds ask for four 256-thread blocks
// an SM at p <= 4 in f32 and bf16 (stage_min_blocks), two above, one in
// f64. No tensor cores: the tap coefficients change per point, and TF32
// would break the f32 gates.
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
// The TMA windows read the fields p deep around the output box as they are
// in memory. On one device the box is the interior and that ring is the
// zero padding the kernels wrote. On a value-halo layout (halo >= 2p deep,
// holding the neighbour blocks' values: parallel/sharded_padded.py) the
// caller passes each stage's box grown by its ring r_J into the halo
// (ops/rk4step.py::stage_rings): stages 0 and 1 write kv0, kv1 to depth p
// (stage 2 reads kv0, stage 3 kv1, at their taps), stages 2 and 3 the
// interior only, since a step's result at a point depends on (u0, v0)
// within 2p of it. The kernel is the same: it writes its box, and "the
// padding" it zeroes is everything outside the box. The box's TMA z start
// moves with the box's h, and tma_window's oz keeps it 16-byte aligned.
//
// bf16 state (T = __nv_bfloat16; f32 and f64 take the same code with
// Acc<T> = T): the fields and tables are bf16 (BFLOAT16 tensor maps, 8
// points a 16-byte unit), the arithmetic float32 (stencil_tiled.cuh::Acc),
// dt, g and the c0 terms float32 (the TPU kernel rounds them to the state
// dtype, pallas_rk4step.py:554). A stage input is rounded once where it
// is stored in its plane, kv0..kv2 and (u1, v1) where they are written.
//
// Each extern "C" launcher returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for a tiling that does not fit the layout, too
// little shared memory, an output that aliases an input, or a tensor map
// that cuTensorMapEncodeTiled refuses.

#include <cuda.h>
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
  Acc<T> dt, g, c0sq, mc0;  // in the arithmetic type: f32 for bf16 state
  bool padding_first;  // the padding layers are the grid's first, else its last
};

// Fields whose plane windows form the stage input, through the TMA ring:
// u0, v0 and kv0 (J = 2) or kv1 (J = 3).
template <int J>
__host__ __device__ constexpr int stage_fields() {
  return J == 0 ? 1 : J == 1 ? 2 : 3;
}

// Stage-input planes: two (a plane's un_J is formed while the threads may
// still read the previous plane's), none for stage 0, which reads u0's
// window as it is.
template <int J>
__host__ __device__ constexpr int stage_extra() {
  return J == 0 ? 0 : 2;
}

// Planes in a stage's TMA ring: kRing for one field a plane (the depth of
// kernel I), four for two and three for three, so that four blocks an SM
// fit in f32 (measured at the P1 size: a deeper ring for two or three
// fields was slower, PERF.md section 6).
template <int NF>
__host__ __device__ constexpr int stage_ring() {
  return NF == 1 ? kRing : NF == 2 ? 4 : 3;
}

// Tile blocks an SM the launch bounds ask for: four at p <= 4 in f32 and
// bf16 (64 registers a thread; at the P1 size 0.32 ms a step, two blocks
// 0.35), else tma_min_blocks<T>().
template <typename T, int P>
__host__ __device__ constexpr int stage_min_blocks() {
  return sizeof(T) <= 4 && P <= 4 ? 4 : tma_min_blocks<T>();
}

// Write 0 to the padding of o0 (and of o1 when it is not null): every point
// of the padded state outside the box, this block's share (block of
// blocks). The x planes outside the box are contiguous whole 16-byte units
// (the state's rows are: tma_fits), dealt over all the blocks' threads and
// written 16 bytes a store. The box's x planes' (x, y) rows are dealt to
// groups of gs = min(32, threads) threads, a contiguous run of rows a
// group: a row outside the box's rows in 16-byte stores, the other rows'
// z points outside the box one store each.
template <typename T>
__device__ void zero_padding(const PaddedBox& s, const Tiling& t, int block, int blocks,
                             T* o0, T* o1) {
  constexpr int V = 16 / (int)sizeof(T);  // points of a 16-byte unit
  const uint4 zu = make_uint4(0u, 0u, 0u, 0u);
  const int nt = t.ty * t.tz;
  uint4* w0 = reinterpret_cast<uint4*>(o0);
  uint4* w1 = reinterpret_cast<uint4*>(o1);
  const long long lo = (long long)s.x0 * s.F() / V;           // units before the box
  const long long hi = (long long)(s.x0 + s.nx) * s.F() / V;  // the first after it
  const long long n = lo + ((long long)s.Lx * s.F() / V - hi);
  for (long long i = (long long)block * nt + threadIdx.x; i < n;
       i += (long long)blocks * nt) {
    const long long k = i < lo ? i : i - lo + hi;
    w0[k] = zu;
    if (o1) w1[k] = zu;
  }
  const int gs = nt < 32 ? nt : 32;
  const int groups = nt / gs;
  const int grp = (int)threadIdx.x / gs;
  const int lane = (int)threadIdx.x - grp * gs;
  if (grp >= groups) return;
  const long long rows = (long long)s.nx * s.Ly;
  const long long ng = (long long)blocks * groups;
  const long long k = (long long)block * groups + grp;
  const int r1 = (int)(rows * (k + 1) / ng);
  int r = (int)(rows * k / ng);
  int g = s.x0 + r / s.Ly;
  int y = r - (g - s.x0) * s.Ly;
  for (; r < r1; ++r) {
    const long long base = ((long long)g * s.Ly + y) * s.Lz;
    if (y < s.h || y >= s.h + s.ny) {
      for (int u = lane; u < s.Lz / V; u += gs) {
        w0[base / V + u] = zu;
        if (o1) w1[base / V + u] = zu;
      }
    } else {  // [0, h) and [h + nz, Lz)
      for (int j = lane; j < s.Lz - s.nz; j += gs) {
        const int z = j < s.h ? j : j + s.nz;
        o0[base + z] = zero<T>();
        if (o1) o1[base + z] = zero<T>();
      }
    }
    if (++y == s.Ly) {
      y = 0;
      ++g;
    }
  }
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

template <typename T, int P, int J>
__global__ void __launch_bounds__(kTileThreads, (stage_min_blocks<T, P>()))
    rk4_tiled_kernel(const __grid_constant__ CUtensorMap m_u0,
                     const __grid_constant__ CUtensorMap m_v0,
                     const __grid_constant__ CUtensorMap m_k,
                     Stencil<T> s, StageArgs<T> a, Tiling t) {
  using A = Acc<T>;
  constexpr int K = 2 * P + 1;
  constexpr int NF = stage_fields<J>();
  constexpr int R = stage_ring<NF>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  long long pb, npb;
  if (a.padding_first ? padding_block<true>(s, t, pb, npb)
                      : padding_block<false>(s, t, pb, npb)) {  // the outputs' padding
    zero_padding<T>(s, t, (int)pb, (int)npb, J < 3 ? a.kv_out : a.u1,
                    J < 3 ? nullptr : a.v1);
    return;
  }

  const TileCoords c(s, t, a.padding_first ? padding_layers(s, t) : 0);
  const TmaWindow w = tma_window<T>(s, t, P);
  const PlaneRing<T, R> ring(smem_raw, w, NF, stage_extra<J>());
  const CUtensorMap* maps[3] = {&m_u0, &m_v0, &m_k};
  const int zs = c.z0 - P - w.oz;  // the box's origin in every plane
  const int ys = c.y0 - P;
  const int iters = c.xe - c.xs + 2 * P;  // planes xs - P .. xe + P - 1
  if (threadIdx.x == 0) {
    for (int i = 0; i < R - 1 && i < iters; ++i) {
      ring.fetch(i, maps, zs, ys, c.xs - P + i);
    }
  }
  ColumnTables<T, P> tab;
  tab.load(s, c.f, c.active);
  const A w1 = c.active ? widen(a.w1[c.f]) : A(0);
  const A w2 = c.active ? widen(a.w2[c.f]) : A(0);
  A q[K];  // q[k] = un_J at row gi - 2P + k after plane gi
#pragma unroll
  for (int k = 0; k < K; ++k) q[k] = A(0);
  A yzq[P];  // yzq[j] = the y/z sum at row gi - P + 1 + j after plane gi
#pragma unroll
  for (int j = 0; j < P; ++j) yzq[j] = A(0);

  const A dt = a.dt;
  const A half = A(0.5);
  const bool lean = a.lean != 0;
  const int F = s.F();
  const int W = w.W;
  const int box = w.box;
  const int WF = t.tz + 2 * P;  // the formed columns of a window row
  const int nt = t.ty * t.tz;
  const int co = (c.ly + P) * W + (c.lz + P + w.oz);  // the column in a box
  // the thread's first formed point (row r0, column c0 of the halo box) and
  // the step to its next, nt points on: dr rows and dc columns
  const int r0 = (int)threadIdx.x / WF;
  const int c0 = (int)threadIdx.x - r0 * WF;
  const int dr = nt / WF;
  const int dc = nt - dr * WF;
  // The point-wise fields at the output row of this plane (pt) and of the
  // next (pn), loaded a plane ahead so that their latency hides behind a
  // plane: stage 3 u0, v0, kv0, kv1, kv2; stages 0..2 v0 and the kv of
  // vn_J (none, kv0, kv1), on the absorbing row only.
  constexpr int NP = J == 3 ? 5 : 2;
  A pt[NP], pn[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) pn[j] = A(0);
  for (int i = 0; i < iters; ++i) {
    const int gi = c.xs - P + i;
#pragma unroll
    for (int j = 0; j < NP; ++j) pt[j] = pn[j];
    const int gn = gi + 1 - P;  // the next plane's output row
    if (c.active && i + 1 >= 2 * P && i + 1 < iters) {
      const long long nidx = (long long)gn * F + c.f;
      if constexpr (J == 3) {
        pn[0] = widen(a.u0[nidx]);
        pn[1] = widen(a.v0[nidx]);
        pn[2] = widen(a.kv0[nidx]);
        pn[3] = widen(a.kv1[nidx]);
        pn[4] = widen(a.kv2[nidx]);
      } else if (gn == a.abc_x) {
        pn[0] = widen(a.v0[nidx]);
        if constexpr (J > 0) pn[1] = widen((J == 1 ? a.kv0 : a.kv1)[nidx]);
      }
    }
    ring.wait(i);
    const T* sl = ring.slot(i);
    const T* ctr;
    if constexpr (J > 0) {  // un_J once per point of the halo box, stored in
                            // T: bf16 rounds it here
      T* un = ring.extra(i & 1);
      for (int r = r0, cc = c0; r < w.BY; r += dr, cc += dc) {
        if (cc >= WF) {
          cc -= WF;
          if (++r >= w.BY) break;
        }
        const int j = r * W + w.oz + cc;
        un[j] = narrow<T>(stage_input<A, J>(
            widen(sl[j]), widen(sl[box + j]), NF > 2 ? widen(sl[2 * box + j]) : A(0),
            lean, dt));
      }
      ctr = un + co;
    } else {
      ctr = sl + co;
    }
    __syncthreads();  // un_J of plane gi is complete, and every thread is
                      // past plane gi - 1: refill its slot
    if (threadIdx.x == 0 && i + R - 1 < iters) {
      ring.fetch(i + R - 1, maps, zs, ys, gi + R - 1);
    }
#pragma unroll
    for (int k = 0; k < K - 1; ++k) q[k] = q[k + 1];
    q[K - 1] = widen(ctr[0]);
    const A yz_new =
        c.active && gi >= c.xs && gi < c.xe ? tab.yz(ctr, W) : A(0);
    const A yz = yzq[0];
#pragma unroll
    for (int j = 0; j < P - 1; ++j) yzq[j] = yzq[j + 1];
    yzq[P - 1] = yz_new;

    if (i < 2 * P || !c.active) continue;
    const int g = gi - P;  // the output row
    const long long idx = (long long)g * F + c.f;
    A kv = x_taps<A, P>(s, q, g) * tab.fx + yz * widen(__ldg(&s.sx[g]));
    if (g == a.src_x) kv += (a.c0sq * a.g) * w1;
    if (g == a.abc_x) {
      A vn;
      if constexpr (J == 0) {
        vn = pt[0];
      } else if constexpr (J < 3) {
        vn = pt[0] + (half * dt) * pt[1];
      } else {
        vn = pt[1] + dt * pt[4];
      }
      kv += (a.mc0 * w2) * vn;
    }
    if constexpr (J < 3) {
      a.kv_out[idx] = narrow<T>(kv);
    } else if (lean) {
      const A dt2 = dt * dt;
      const A v0 = pt[1];
      const A k1 = pt[3];
      const A k2 = pt[4];
      const A s2 = (pt[2] + k1) + k2;
      a.u1[idx] = narrow<T>((pt[0] + dt * v0) + (dt2 / A(6)) * s2);
      a.v1[idx] = narrow<T>(v0 + (dt / A(6)) * (((s2 + k1) + k2) + kv));
    } else {
      const A b0 = A(1.0 / 6.0);
      const A b1 = A(1.0 / 3.0);
      const A v0 = pt[1];
      const A k0 = pt[2];
      const A k1 = pt[3];
      const A k2 = pt[4];
      const A vn1 = v0 + (half * dt) * k0;
      const A vn2 = v0 + (half * dt) * k1;
      const A vn3 = v0 + dt * k2;
      const A accu = ((b0 * v0 + b1 * vn1) + b1 * vn2) + b0 * vn3;
      const A accv = ((b0 * k0 + b1 * k1) + b1 * k2) + b0 * kv;
      a.u1[idx] = narrow<T>(pt[0] + dt * accu);
      a.v1[idx] = narrow<T>(v0 + dt * accv);
    }
  }
}

template <typename T, int P, int J>
int launch_stage(Stencil<T> s, StageArgs<T> a, Tiling t, dim3 grid, int smem,
                 cudaStream_t stream) {
  constexpr int NF = stage_fields<J>();
  const TmaWindow w = tma_window<T>(s, t, P);
  const T* ins[3] = {a.u0, a.v0, J == 2 ? a.kv0 : a.kv1};
  for (int f = 0; f < NF; ++f) {
    if (!tma_fits<T>(s, t, w, ins[f])) return (int)cudaErrorInvalidValue;
  }
  if (smem < tma_smem_bytes<T>(w, NF, stage_extra<J>(), stage_ring<NF>())) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap maps[3];
  for (int f = 0; f < NF; ++f) {
    const int e = encode_plane_map<T>(&maps[f], ins[f], s, w);
    if (e != 0) return e;
  }
  for (int f = NF; f < 3; ++f) maps[f] = maps[0];  // not read
  auto kernel = rk4_tiled_kernel<T, P, J>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, t.ty * t.tz, smem, stream>>>(maps[0], maps[1], maps[2], s, a, t);
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
  // the outputs are written while the TMA windows and the point-wise loads
  // read the inputs
  const T* ins[5] = {a.u0, a.v0, a.kv0, a.kv1, a.kv2};
  const T* outs[2] = {stage < 3 ? a.kv_out : a.u1, stage < 3 ? a.kv_out : a.v1};
  for (const T* o : outs) {
    if ((uintptr_t)o % 16 != 0) return (int)cudaErrorInvalidValue;  // 16-byte zeros
    for (int f = 0; f < 5; ++f) {
      // stage J < 3 reads u0, v0 and kv0 (J = 1, 2) or kv1 (J = 2); stage
      // 3 reads all five
      const bool read = f < 2 || stage == 3 || (f == 2 && stage > 0) ||
                        (f == 3 && stage == 2);
      if (read && o == ins[f]) return (int)cudaErrorInvalidValue;
    }
  }
  // the tiles and x-chunks, then at least one layer of padding blocks
  const int chunks = (s.nx + t.cx - 1) / t.cx;
  if ((int)grid.z <= chunks || !tiling_fits(t, dim3(grid.x, grid.y, chunks), s.nx, s.ny, s.nz) ||
      !box_fits_int(s) || s.x0 < s.p || s.h < s.p) {
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
// interior grown into the halo by the stage's ring. The last eight ints
// are ops/rk4step.py::stage_geometry's tiling of the box: ty, tz, cx, the
// grid (gx, gy, gz), the dynamic shared memory in bytes, and whether the
// padding layer goes first (tiling.tma_padding_first).
// ---------------------------------------------------------------------------

#define WAVE_DEFINE_RK4_STAGE(T, SUFFIX, NAME, LEAN)                          \
  extern "C" int NAME##_##SUFFIX(                                             \
      int stage, const T* u0, const T* v0, const T* kv0, const T* kv1,        \
      const T* kv2, T* kv_out, T* u1, T* v1, const T* w1, const T* w2,        \
      int src_x, int abc_x, double dt, double g, double c0, const T* cvx,     \
      const T* sx, const T* fx, const T* cvy, const T* cvz, int p, int Lx,    \
      int Ly, int Lz, int x0, int nx, int h, int ny, int nz, int ty, int tz,  \
      int cx, int gx, int gy, int gz, int smem, int padding_first,            \
      cudaStream_t stream) {                                                  \
    using A = wave::Acc<T>;                                                   \
    wave::StageArgs<T> a{u0, v0, kv0, kv1, kv2, kv_out, u1, v1, w1, w2,       \
                         src_x, abc_x, LEAN, (A)dt, (A)g, (A)(c0 * c0),       \
                         (A)(-c0), padding_first != 0};                       \
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
