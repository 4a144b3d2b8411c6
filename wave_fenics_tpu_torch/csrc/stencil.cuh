// The padded wave stencil A = -c0^2 K / m on the flat padded layout.
//
// State lives as [Lx, F] with F = Ly * Lz (ops/wave.py::PaddedLayout, the
// JAX package's layout unchanged): row g is a padded x index, column
// f = y * Lz + z a padded (y, z) point. The interior box is rows
// [x0, x0 + nx), y in [h, h + ny), z in [h, h + nz); everything outside it
// is zero padding and stays zero.
//
// At an interior point (g, f), with K = 2p + 1 taps per axis,
//
//   (A x)[g, f] = fx[f] * sum_k cvx[k, g] * x[g + k - p, f]          (x band)
//               + sx[g] * ( sum_k cvy[k, f] * x[g, f + (k - p) * Lz]  (y taps)
//                         + sum_k cvz[k, f] * x[g, f + (k - p)] )     (z taps)
//
// cvx holds the banded x coefficients (face corrections and the x factor
// of 1/m folded in), cvy/cvz the y/z coefficients with the z/y lumped
// lines folded in, fx the outer product of the y and z lines and sx the x
// line (all built by ops/wave.py::stencil_tables). The two shift-0 taps
// of the y and z stencils are merged into one term, as in the TPU step
// kernel. The kernels that apply it stream it through shared memory, in
// the sum order of stencil_tiled.cuh (x_taps, ColumnTables::yz); the
// padding is at least p deep on every side, so no tap of an interior point
// leaves the state.
#pragma once

#include <cuda_runtime.h>

namespace wave {

// The geometry of a padded layout, without its tables: the padded extents
// and the interior box. The tiled kernels (stencil_tiled.cuh) need only
// this, so both layouts' stencils provide it.
struct PaddedBox {
  int p, Lx, Ly, Lz;
  int x0, nx, h, ny, nz;

  __host__ __device__ __forceinline__ int F() const { return Ly * Lz; }
};

template <typename T>
struct Stencil : PaddedBox {
  const T* cvx;  // [K, Lx]
  const T* sx;   // [Lx]
  const T* fx;   // [F]
  const T* cvy;  // [K, F]
  const T* cvz;  // [K, F]

  __host__ __device__ Stencil(const T* cvx_, const T* sx_, const T* fx_,
                              const T* cvy_, const T* cvz_, int p_, int Lx_,
                              int Ly_, int Lz_, int x0_, int nx_, int h_,
                              int ny_, int nz_)
      : PaddedBox{p_, Lx_, Ly_, Lz_, x0_, nx_, h_, ny_, nz_},
        cvx(cvx_), sx(sx_), fx(fx_), cvy(cvy_), cvz(cvz_) {}
};

// The same A on the 3D-slab layout [Lx, Ly, Lz] (z aligned to 128; kernel
// E, slab_tiled.cu), with the TPU kernel's tables as they are: the banded coefficients
// cvx [K, Lx], cvy [K, Ly], cvz [K, Lz] and the three 2D line tables
// lyz [Ly, Lz], lxz [Lx, Lz], lxy [Lx, Ly] (two scaled lumped lines each,
// 1/m folded in; ops/wave.py::build_tables). At an interior point
//
//   (A x)[x, y, z] = lyz[y, z] * sum_k cvx[k, x] * x[x + k - p, y, z]
//                  + lxz[x, z] * sum_k cvy[k, y] * x[x, y + k - p, z]
//                  + lxy[x, y] * sum_k cvz[k, z] * x[x, y, z + k - p],
//
// the y and z sums starting from their shift-0 tap, as the TPU kernel's.
// The caller guarantees a padding at least p deep on every side, so no
// tap of an interior point leaves the state and none is masked.
template <typename T>
struct SlabStencil : PaddedBox {
  const T* lyz;
  const T* lxz;
  const T* lxy;
  const T* cvx;
  const T* cvy;
  const T* cvz;

  __host__ __device__ SlabStencil(const T* lyz_, const T* lxz_, const T* lxy_,
                                  const T* cvx_, const T* cvy_, const T* cvz_,
                                  int p_, int Lx_, int Ly_, int Lz_, int x0_,
                                  int nx_, int h_, int ny_, int nz_)
      : PaddedBox{p_, Lx_, Ly_, Lz_, x0_, nx_, h_, ny_, nz_},
        lyz(lyz_), lxz(lxz_), lxy(lxy_), cvx(cvx_), cvy(cvy_), cvz(cvz_) {}
};

}  // namespace wave
