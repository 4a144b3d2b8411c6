"""Padded-layout wave model: the port's hot path.

Port of ``wave_fenics_tpu.models.linear_wave_padded.PaddedLinearWave``
(flat layout) with the RK4 step path of its ``_StepMixin``. Same physics as
:class:`models.linear_wave.LinearWave`, with the state kept permanently in
the padded layout of ``ops.wave``:

- ``f1``/``solve``/``solve_n``: RK4 on ``f1`` = kernel B (stiffness/m)
  plus the source/ABC contributions as single-plane updates;
- ``solve_step_n``: one RK4 step per call of kernel A (four stage
  launches on the card), for x-face source/ABC problems.

Dispatch follows the state's device: CPU tensors run the plain versions,
CUDA tensors the hand-written kernels. Nothing falls back: where the step
path does not apply, ``solve_step_n`` raises.

Time is a Python float accumulated ``t += dt`` as the JAX package does it,
and g(t) is evaluated on the host in float64. The JAX package carries t in
the state dtype, so in float32 its source phase drifts from this one; in
float64 the two agree.

Not ported yet (ROADMAP.md): the 3D-slab kernel the JAX package takes for
p > 8 or ``kernel='3d'``, the fused per-stage, leapfrog and 2-step RK4
mixins, and ``solve_step_dyn`` (a traced step count has no use in eager
PyTorch: ``solve_step_n`` takes any count).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..convert import numpy_dtype
from ..core.basis import lumped_weight_line
from ..core.mesh import BOX_FACETS
from ..ops.rk4step import (
    StepTables,
    _off0,
    build_step_tables,
    rk4_step_lean,
)
from ..ops.separable import grid_lines, separable_stiffness_tables
from ..ops.wave import (
    FlatTables,
    PaddedLayout,
    StencilTables,
    apply_flat,
    build_tables_flat,
    stencil_tables,
)
from ..solvers.rk4 import rk4_solve, rk4_solve_n
from .linear_wave import LinearWave, lumped_boundary_weights

__all__ = ["PaddedLinearWave"]

_RK_C = (0.0, 0.5, 0.5, 1.0)


def _flat_tile_x(p: int, want: int = 16) -> int:
    """Smallest tile >= want that is a multiple of both p and 8."""
    t = max(p, want, 8)
    while t % p or t % 8:
        t += 1
    return t


class PaddedLinearWave(nn.Module):
    """``base`` in the padded flat layout; tables are buffers on the base
    model's device."""

    def __init__(self, base: LinearWave, tile_x: int = 16):
        super().__init__()
        b = base
        if b.p > 8:
            raise ValueError(
                f"p = {b.p}: the flat padded layout supports p <= 8; the "
                "3D-slab kernel the JAX package uses beyond that "
                "(ops/pallas_wave.py::_kernel, kernel E) is not ported yet"
            )
        self.base = b
        shape = tuple(n * b.p + 1 for n in b.mesh.shape)
        self.layout = PaddedLayout(
            shape=shape, p=b.p, tile_x=_flat_tile_x(b.p, tile_x), z_align=16
        )
        self.layout.check_flat()
        self._m_lines = [
            lumped_weight_line(b.mesh.shape[d], b.p, b.mesh.h[d])
            for d in range(3)
        ]
        A, _ = separable_stiffness_tables(b.p, b.mesh.h, b.dtype)
        lines = grid_lines(b.mesh.shape, b.p, b.dtype)
        coeff = -float(b.c0) ** 2
        self._register("flat", FlatTables, build_tables_flat(
            self.layout, A, lines, coeff, self._m_lines, b.dtype))
        self._register("stencil", StencilTables, stencil_tables(
            self.layout, A, lines, coeff, self._m_lines, b.dtype))

        self._planes = []  # (axis, padded index, 'w1'|'w2')
        for i, (axis, pidx, attr, plane) in enumerate(self._build_boundary_planes()):
            self._planes.append((axis, pidx, attr))
            self.register_buffer(f"plane_{i}", self._tensor(plane))

        # the step path: x-face source/ABC planes and a tile that holds the
        # 3p slab halo (the JAX package's conditions, kept so both packages
        # take the step path on the same configurations)
        self.step_unavailable = None
        planes = _x_face_planes(self)
        if self.layout.tile_x < _off0(b.p):
            self.step_unavailable = (
                f"tile_x = {self.layout.tile_x} < the 3p slab halo {_off0(b.p)}")
        elif planes is None:
            self.step_unavailable = (
                "needs exactly one source and one absorbing plane, both on "
                "x-faces")
        else:
            w1, w2, self.src_x, self.abc_x = planes
            self._register("step", StepTables, build_step_tables(
                self.layout, A, lines, coeff, self._m_lines,
                w1, w2, self.src_x, self.abc_x, dtype=b.dtype))
        self._work = None

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.base.device)

    def _register(self, prefix, kind, arrays):
        for name, a in zip(kind._fields, arrays):
            self.register_buffer(f"{prefix}_{name}", self._tensor(a))

    def _tables(self, prefix, kind):
        return kind(*(getattr(self, f"{prefix}_{n}") for n in kind._fields))

    @property
    def flat_tables(self) -> FlatTables:
        return self._tables("flat", FlatTables)

    @property
    def stencil(self) -> StencilTables:
        return self._tables("stencil", StencilTables)

    @property
    def step_tables(self) -> StepTables | None:
        if self.step_unavailable is not None:
            return None
        return self._tables("step", StepTables)

    def _build_boundary_planes(self):
        """[(axis, padded index, 'w1'|'w2', plane)] with the 2D planes
        premultiplied by 1/m and padded to the padded dims of their axes."""
        b = self.base
        lay = self.layout
        m3 = np.einsum("i,j,k->ijk", *self._m_lines)
        tags = b.mesh.facet_tags
        out = []
        npdt = numpy_dtype(b.dtype)
        for tag, attr in ((b.source_tag, "w1"), (b.abc_tag, "w2")):
            for fid in tags.facets_of(tag):
                axis, side = BOX_FACETS[fid]
                W = lumped_boundary_weights(b.mesh, b.p, (fid,))
                idx = [slice(None)] * 3
                n_ax = W.shape[axis]
                idx[axis] = 0 if side == 0 else n_ax - 1
                plane = (W / m3)[tuple(idx)]
                oth = [d for d in range(3) if d != axis]
                pp = np.zeros(
                    (lay.padded_shape[oth[0]], lay.padded_shape[oth[1]]),
                    dtype=npdt,
                )
                o0 = lay.x0 if oth[0] == 0 else lay.h
                o1 = lay.h  # oth[1] is never axis 0
                pp[o0 : o0 + plane.shape[0], o1 : o1 + plane.shape[1]] = plane
                off = lay.x0 if axis == 0 else lay.h
                pidx = [slice(None)] * 3
                pidx[axis] = off if side == 0 else off + n_ax - 1
                out.append((axis, tuple(pidx), attr, pp))
        return out

    @property
    def _boundary_planes(self):
        return [(axis, pidx, attr, getattr(self, f"plane_{i}"))
                for i, (axis, pidx, attr) in enumerate(self._planes)]

    # -- physics --------------------------------------------------------
    def _apply(self, u: torch.Tensor) -> torch.Tensor:
        """-c0^2 (K u)/m on the padded state (kernel B on a CUDA tensor)."""
        return apply_flat(u, self.layout, self.flat_tables, self.stencil)

    def f1(self, t, u, v):
        b = self.base
        kv = self._apply(u)
        for axis, pidx, attr, plane in self._boundary_planes:
            if attr == "w1":
                g = torch.tensor(b.c0**2 * b.g_amplitude(t), dtype=b.dtype)
                kv[pidx] += g * plane
            else:
                kv[pidx] += -b.c0 * plane * v[pidx]
        return kv

    def f0(self, t, u, v):
        return v

    # -- time stepping ---------------------------------------------------
    def zero_state(self):
        z = torch.zeros(self.layout.padded_shape, dtype=self.base.dtype,
                        device=self.base.device)
        return z, z

    def solve(self, t0, tf, dt, u0=None, v0=None):
        if u0 is None:
            u0, v0 = self.zero_state()
        return rk4_solve(self.f0, self.f1, u0, v0, t0, tf, dt)

    def solve_n(self, t0, dt, nsteps, u0=None, v0=None):
        if u0 is None:
            u0, v0 = self.zero_state()
        return rk4_solve_n(self.f0, self.f1, u0, v0, t0, dt, nsteps)

    def to_grid(self, xp: torch.Tensor) -> torch.Tensor:
        return self.layout.unpad(xp)

    def from_grid(self, x: torch.Tensor) -> torch.Tensor:
        return self.layout.pad(x)

    def _workspace(self):
        """Kernel A's buffers, allocated once per model: two ping-pong
        (u, v) pairs and the stage scratch (kv0, kv1, kv2)."""
        if self._work is None:
            e = lambda: torch.empty(  # noqa: E731
                self.layout.padded_shape, dtype=self.base.dtype,
                device=self.base.device)
            self._work = ((e(), e()), (e(), e())), (e(), e(), e())
        return self._work

    def solve_step_n(self, t0, dt, nsteps, u0=None, v0=None):
        """RK4 with one step-kernel call per timestep; returns (u, v, nsteps).

        Raises ValueError when the step path does not apply to this
        configuration (no fallback to another solver)."""
        tables = self.step_tables
        if tables is None:
            raise ValueError(
                "fused RK4 step kernel unavailable for this config "
                f"({self.step_unavailable})"
            )
        if u0 is None:
            u0, v0 = self.zero_state()
        b = self.base
        dtf = float(dt)
        t = float(t0)
        cuda = u0.device.type == "cuda"
        pairs, scratch = self._workspace() if cuda else ((None, None), None)
        stencil = self.stencil
        u, v = u0, v0
        for i in range(nsteps):
            gs = [b.g_amplitude(t + c * dtf) for c in _RK_C]
            # ping-pong: a step never writes the pair it reads
            u, v = rk4_step_lean(
                u, v, dtf, gs, self.layout, b.c0, tables, stencil,
                self.src_x, self.abc_x, out=pairs[i % 2], scratch=scratch,
            )
            t = t + dtf
        if cuda:  # hand out tensors the next solve will not overwrite
            u, v = u.clone(), v.clone()
        return u, v, nsteps


def _x_face_planes(pm: PaddedLinearWave):
    """(w1_flat, w2_flat, src_x, abc_x) if all tagged faces are x-faces with
    exactly one source and one absorbing plane; None otherwise."""
    w1 = w2 = None
    src_x = abc_x = None
    for axis, pidx, attr, plane in pm._boundary_planes:
        if axis != 0:
            return None
        row = pidx[0]
        if attr == "w1":
            if w1 is not None:
                return None
            w1, src_x = plane.cpu().numpy().ravel(), row
        else:
            if w2 is not None:
                return None
            w2, abc_x = plane.cpu().numpy().ravel(), row
    if w1 is None or w2 is None:
        return None
    return w1, w2, src_x, abc_x
