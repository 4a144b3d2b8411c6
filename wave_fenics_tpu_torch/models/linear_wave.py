"""Linear second-order wave equation with source and absorbing boundaries.

Port of ``wave_fenics_tpu.models.linear_wave`` (reference semantics; the
port's own oracle). It mirrors ``LinearGLLOpt`` (common/LinearGLL.hpp:37-288)
and the UFL boundary form (demo/cpu_planar3d/forms.ufl:21-24):

  du/dt = v
  dv/dt = ( -c0^2 K u + c0^2 g(t) W1 - c0 W2 v ) / m
  g(t)  = window(t) * p0 * w0 / c0 * cos(w0 t)        (:162)
  window(t) = 0.5 (1 - cos(f0 pi t / alpha)), t < alpha T; else 1  (:154-159)

GLL facet quadrature is collocated, so the two boundary integrals are
diagonal: precomputed lumped facet-weight grids W1/W2, two pointwise AXPYs.

The source amplitude g(t) is evaluated on the host in float64 from a
Python-float time and enters ``f1`` and ``force`` as a 0-d tensor of the
state dtype (:meth:`WavePhysics._g`; a bf16 state's g rounded to bf16, as
the JAX package rounds it, and the same on the CPU and on a card: a 0-d
float32 tensor would stay float32 in a card's product and be rounded to
bf16 first on the CPU); the JAX package evaluates it on the device in the
time dtype. The two agree in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..convert import as_table, tables_from_numpy
from ..core.basis import lumped_weight_line
from ..core.dofmap import StructuredDofGrid
from ..core.mesh import BOX_FACETS, StructuredBoxMesh
from ..ops.operators import StructuredOperators
from ..solvers.rk4 import rk4_solve, rk4_solve_n_recording

__all__ = ["WavePhysics", "LinearWave", "lumped_boundary_weights", "probe_indices",
           "solve_recording", "require_homogeneous"]


def lumped_boundary_weights(
    mesh: StructuredBoxMesh, p: int, facets: tuple[int, ...]
) -> np.ndarray:
    """Lumped facet-mass grid: W[dof] = sum over tagged facets of the
    integral of the dof's basis function over the facet (GLL-collocated
    facet quadrature => diagonal). Shape = dof grid; nonzero only on the
    selected box faces."""
    shape = tuple(n * p + 1 for n in mesh.shape)
    W = np.zeros(shape)
    for fid in facets:
        axis, side = BOX_FACETS[fid]
        tang = [d for d in range(3) if d != axis]
        lines = [
            lumped_weight_line(mesh.shape[d], p, mesh.h[d]) for d in tang
        ]
        face = np.multiply.outer(lines[0], lines[1])
        idx = [slice(None)] * 3
        idx[axis] = 0 if side == 0 else -1
        W[tuple(idx)] += face
    return W


class WavePhysics(nn.Module):
    """The LinearGLL physics (common/LinearGLL.hpp:141-192) on any operator
    set: a subclass sets ``ops`` (with ``stiffness(u, c0)``), the source
    parameters and the buffers ``inv_m``, ``W1`` and ``W2``, and defines
    ``zero_state``."""

    @property
    def device(self) -> torch.device:
        return self.W1.device

    @property
    def w0(self) -> float:
        return 2.0 * np.pi * self.freq0

    @property
    def period(self) -> float:
        return 1.0 / self.freq0

    # -- physics --------------------------------------------------------
    def window(self, t: float) -> float:
        """Source ramp over the first alpha periods (LinearGLL.hpp:154-159)."""
        Talpha = self.period * self.alpha
        ramp = 0.5 * (1.0 - math.cos(self.freq0 * math.pi * t / self.alpha))
        return ramp if t < Talpha else 1.0

    def g_amplitude(self, t: float) -> float:
        """Uniform source value g(t) (LinearGLL.hpp:162), float64."""
        return self.window(t) * self.p0 * self.w0 / self.c0 * math.cos(self.w0 * t)

    def f0(self, t, u, v):
        """du/dt = v (LinearGLL.hpp:141-144)."""
        return v

    def f1(self, t, u, v):
        """dv/dt = (stiffness + boundary) / m (LinearGLL.hpp:151-192)."""
        b = self.ops.stiffness(u, self.c0)
        b = b + self._g(t) * self.W1 - self.c0 * (self.W2 * v)
        return b * self.inv_m

    def _g(self, t: float) -> torch.Tensor:
        """c0^2 g(t), a 0-d tensor of the state dtype."""
        return torch.tensor(self.c0**2 * self.g_amplitude(t), dtype=self.dtype)

    # -- leapfrog decomposition: f1 = force(t, u) - damping * v ----------
    def force(self, t, u):
        """Mass-normalised v-independent acceleration (stiffness + source)
        of the leapfrog integrator (solvers/leapfrog.py)."""
        b = self.ops.stiffness(u, self.c0)
        return (b + self._g(t) * self.W1) * self.inv_m

    @property
    def damping(self) -> torch.Tensor:
        """Diagonal absorbing-boundary damping D = c0 W2 / m."""
        return self.c0 * self.W2 * self.inv_m

    # -- time stepping ----------------------------------------------------
    def solve(self, t0: float, tf: float, dt: float, u0=None, v0=None):
        """RK4 from t0 to tf; returns (u, v, nsteps)."""
        if u0 is None:
            u0, v0 = self.zero_state()
        return rk4_solve(self.f0, self.f1, u0, v0, t0, tf, dt)


class LinearWave(WavePhysics):
    """The wave model on a structured box: operators + physics + integrator.

    Parameters mirror LinearGLLOpt's constructor
    (common/LinearGLL.hpp:69-128): basis degree, speed of sound, source
    frequency, pressure amplitude; plus boundary tags resolved through the
    mesh's facet_tags (source tag 1, absorbing tag 2, forms.ufl:21-24).
    ``m``, ``inv_m``, ``W1`` and ``W2`` are buffers on ``device`` (the card
    unless the caller asks for the CPU). ``c0_cells`` (optional, [ncells])
    is a per-cell sound speed (heterogeneous media): the stiffness takes
    the per-cell path with the coefficient (c0_cells / c0)^2, and c0 stays
    the reference speed of the source and absorbing terms. The padded and
    sharded models raise on such a model (their tables hold c0 alone).
    ``dtype`` is float32, float64 or bfloat16 (bf16 state: the tables
    rounded once from float64, the stiffness in float32 on the bf16 grid,
    kernel F on a card, and the rest of ``f1`` eager bf16 arithmetic, as
    the JAX package's).
    """

    def __init__(
        self,
        mesh: StructuredBoxMesh,
        p: int,
        c0: float = 1500.0,
        freq0: float = 0.5e6,
        p0: float = 60000.0,
        alpha: float = 4.0,
        source_tag: int = 1,
        abc_tag: int = 2,
        dtype: torch.dtype = torch.float32,
        device: torch.device | str = "cuda",
        c0_cells=None,
    ):
        super().__init__()
        self.mesh = mesh
        self.p = p
        self.c0 = c0
        self.freq0 = freq0
        self.p0 = p0
        self.alpha = alpha
        self.source_tag = source_tag
        self.abc_tag = abc_tag
        self.dtype = dtype
        self.c0_cells = c0_cells
        coeff = None if c0_cells is None else (np.asarray(c0_cells) / c0) ** 2
        self.ops = StructuredOperators(mesh, p, dtype=dtype, coeff_cells=coeff)
        tags = mesh.facet_tags

        def buf(a):  # a NumPy table of the model's dtype (as_table) on device
            return tables_from_numpy((a,), device, dtype)[0]

        # m = M @ 1 (LinearGLL.hpp:105-110) and 1/m precomputed: the
        # optimization the reference left as a TODO (LinearGLL.hpp:179-181)
        self.register_buffer("m", buf(self.ops.lumped_mass))
        self.register_buffer("inv_m", buf(as_table(1.0 / self.ops.lumped_mass, dtype)))
        self.register_buffer("W1", buf(as_table(lumped_boundary_weights(
            mesh, p, tags.facets_of(source_tag)), dtype)))
        self.register_buffer("W2", buf(as_table(lumped_boundary_weights(
            mesh, p, tags.facets_of(abc_tag)), dtype)))

    def zero_state(self) -> tuple[torch.Tensor, torch.Tensor]:
        """u_0 = v_0 = 0 (LinearGLL.hpp:131-134)."""
        z = torch.zeros(self.ops.grid_shape, dtype=self.dtype, device=self.device)
        return z, z


def require_homogeneous(model, who: str) -> None:
    """Raise a ValueError where ``model`` has a per-cell sound speed:
    ``who`` builds its tables from c0 alone (the JAX package's padded and
    sharded models ignore ``c0_cells`` and return the homogeneous answer)."""
    if getattr(model, "c0_cells", None) is not None:
        raise ValueError(f"{who} builds its tables from c0 alone: a model with "
                         "c0_cells (a per-cell sound speed) runs on LinearWave's "
                         "own solvers (the per-cell stiffness)")


def probe_indices(model: LinearWave, points) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Grid indices of the dofs nearest to the given physical points
    (probe/"hydrophone" placement)."""
    dg = StructuredDofGrid(model.mesh, model.p)
    pts = np.atleast_2d(points)
    return tuple(
        np.abs(dg.axis_coords(d)[None, :] - pts[:, d : d + 1]).argmin(axis=1)
        for d in range(3))


def solve_recording(model: LinearWave, t0: float, dt: float, nsteps: int, points,
                    u0=None, v0=None):
    """RK4 solve (``f1``: kernel F on a card) recording the pressure time
    series at probe points. Returns (u, v, series[nsteps, npoints]), the
    series a tensor on the model's device, filled with no host read per
    step."""
    if u0 is None:
        u0, v0 = model.zero_state()
    ii, jj, kk = (torch.as_tensor(i, device=model.device)
                  for i in probe_indices(model, points))

    def sample(t, u, v):
        return u[ii, jj, kk]

    return rk4_solve_n_recording(model.f0, model.f1, u0, v0, t0, dt, nsteps, sample)
