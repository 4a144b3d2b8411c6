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
// kernel. Every read outside [0, Lx) x [0, F) is masked: for an interior
// point none occurs (the padding is at least p deep on every side), so the
// masks only guard against a layout that breaks that rule.
#pragma once

#include <cuda_runtime.h>

namespace wave {

template <typename T>
struct Stencil {
  const T* cvx;  // [K, Lx]
  const T* sx;   // [Lx]
  const T* fx;   // [F]
  const T* cvy;  // [K, F]
  const T* cvz;  // [K, F]
  int p, Lx, Ly, Lz;
  int x0, nx, h, ny, nz;

  __device__ __forceinline__ int F() const { return Ly * Lz; }

  __device__ __forceinline__ bool interior(int g, int f) const {
    const int y = f / Lz;
    const int z = f - y * Lz;
    return g >= x0 && g < x0 + nx && y >= h && y < h + ny && z >= h &&
           z < h + nz;
  }
};

// (A x)[g, f]; load(g', f') returns x at row g', column f'.
template <typename T, typename Load>
__device__ __forceinline__ T apply_stencil(const Stencil<T>& s,
                                           const Load& load, int g, int f) {
  const int p = s.p;
  const int K = 2 * p + 1;
  const int F = s.F();

  T tx = T(0);
  for (int k = 0; k < K; ++k) {
    const int gg = g + k - p;
    if (gg >= 0 && gg < s.Lx) tx += s.cvx[k * s.Lx + g] * load(gg, f);
  }

  T yz = (s.cvy[p * F + f] + s.cvz[p * F + f]) * load(g, f);
  for (int k = 0; k < K; ++k) {
    if (k == p) continue;
    const int ff = f + (k - p) * s.Lz;
    if (ff >= 0 && ff < F) yz += s.cvy[k * F + f] * load(g, ff);
  }
  for (int k = 0; k < K; ++k) {
    if (k == p) continue;
    const int ff = f + (k - p);
    if (ff >= 0 && ff < F) yz += s.cvz[k * F + f] * load(g, ff);
  }
  return tx * s.fx[f] + yz * s.sx[g];
}

}  // namespace wave
