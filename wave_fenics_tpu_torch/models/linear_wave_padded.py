"""Padded-layout wave model: the port's hot path.

Port of ``wave_fenics_tpu.models.linear_wave_padded.PaddedLinearWave``
with the solver paths of its ``_StepMixin``, ``_FusedMixin``,
``_LFStepMixin``, ``_LF2StepMixin`` and ``_RK42StepMixin``. Same physics as
:class:`models.linear_wave.LinearWave`, with the state kept permanently in
the padded layout of ``ops.wave``: the flat layout (z aligned to 16), or,
for ``kernel='3d'`` and for p > 8 (the flat layout's 8-deep halo window
holds p <= 8), the 3D-slab layout (z aligned to 128), as the JAX model
resolves it.

- ``f1``/``solve``/``solve_n``: RK4 on ``f1`` = the stiffness/m (kernel B
  on the flat layout, kernel E on the 3D-slab layout) plus the source/ABC
  contributions as single-plane updates; ``force`` and ``damping`` split
  ``f1`` for ``solvers/leapfrog.py``;
- ``solve_step_n``: one RK4 step per call of kernel A (lean, the default)
  or kernel C (``lean=False``, the full Butcher tableau), four stage
  launches each on the card;
- ``solve_fused_n``: RK4 with one call of the stage kernel D per stage;
- ``solve_lf_n``: leapfrog, one step per call of kernel H (two launches);
- ``solve_lf2_n``: leapfrog, two steps per call of kernel I (three
  launches), an odd last step through kernel H;
- ``solve_step2_n``: RK4, two full-tableau steps per call of kernel J
  (seven launches), an odd last step through the step kernel ``lean``
  selects (A, or C).

Spans (``utils/profiling.py``, recorded only under a ``torch.profiler``):
``solve_step_n`` opens ``wave.rk4.solve`` around the call and
``wave.rk4.step`` around each step, ``solve_lf2_n`` ``wave.lf2.solve``
and ``wave.lf2.call`` around each call of kernel I, and each kernel-H step
``wave.lf.step``.

Each kernel path needs the flat layout, one source and one absorbing plane,
both on x-faces, and the step paths a tile that holds their TPU kernel's
slab halo (the JAX package's conditions, kept so both packages take the
same path on the same configuration). Dispatch follows the state's device:
CPU tensors run the plain versions, CUDA tensors the hand-written kernels.
Nothing falls back: where a path does not apply, its solver raises a
ValueError that names the unmet condition (``step_unavailable``,
``stage_unavailable``, ``lf_unavailable``, ``lf2_unavailable``,
``rk42_unavailable``).

Time is a Python float accumulated ``t += dt`` as the JAX package does it,
and g(t) is evaluated on the host in float64. The JAX package carries t in
the state dtype, so in float32 its source phase drifts from this one; in
float64 the two agree; in bf16 its fused solvers' source never switches on
(a bf16 t rounds the window to 0), where this one's does.

bf16 state (``base.dtype == torch.bfloat16``): the tables rounded once
from float64 (the JAX package's bf16 tables bit for bit) and every path
above on its kernel's bf16 form: ``solve_step_n``
on kernel A (C with ``lean=False``), ``solve_fused_n`` on D,
``solve_lf_n`` on H, ``solve_lf2_n`` on I, ``solve_step2_n`` on J, and
``solve_n``/``force`` on B, or on E in the 3D-slab layout, with eager bf16
vector algebra around them as the JAX package's bf16 ``solve_n`` has.

Not ported (ROADMAP.md): the ``*_dyn`` solvers (a traced step count has no
use in eager PyTorch: the ``*_n`` solvers take any count).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..convert import table_dtype, tables_from_numpy
from ..core.basis import lumped_weight_line
from ..core.mesh import BOX_FACETS
from ..ops import lf2step, lfstep, rk42step
from ..ops.lf2step import LF2Tables, build_lf2_tables, lf2_step
from ..ops.lfstep import LFTables, build_lf_tables, lf_step
from ..ops.rk42step import rk42_step
from ..ops.rk4step import (
    StepTables,
    _off0,
    build_step_tables,
    rk4_step_full,
    rk4_step_lean,
)
from ..ops.separable import grid_lines, separable_stiffness_tables
from ..ops.wave import (
    FlatTables,
    PaddedLayout,
    SlabTables,
    StencilTables,
    apply_flat,
    apply_slab,
    build_tables,
    build_tables_flat,
    check_slab,
    rk_stage,
    stencil_tables,
)
from ..solvers.rk4 import rk4_solve, rk4_solve_n
from ..utils.profiling import annotate
from .linear_wave import LinearWave, lumped_boundary_weights, require_homogeneous

__all__ = ["PaddedLinearWave"]

_RK_A = (0.0, 0.5, 0.5, 1.0)
_RK_B = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)
_RK_C = (0.0, 0.5, 0.5, 1.0)
_NO_X_FACES = "needs exactly one source and one absorbing plane, both on x-faces"
_NEEDS_FLAT = "needs the flat layout (kernel='3d' or p > 8)"


def _flat_tile_x(p: int, want: int = 16) -> int:
    """Smallest tile >= want that is a multiple of both p and 8."""
    t = max(p, want, 8)
    while t % p or t % 8:
        t += 1
    return t


class PaddedLinearWave(nn.Module):
    """``base`` in a padded layout; tables are buffers on the base model's
    device. ``kernel`` is the JAX model's: 'flat' (z aligned to 16, tile
    rounded to a multiple of p and 8) or '3d' (the 3D-slab layout, z
    aligned to 128, the tile as given); 'flat' at p > 8 resolves to '3d'
    (``self.kernel`` holds the resolved name). ``lean`` selects the RK4 step
    kernel of ``solve_step_n`` and of ``solve_step2_n``'s odd last step: the
    collapsed stage algebra (kernel A, the default) or the full Butcher
    tableau (kernel C)."""

    def __init__(self, base: LinearWave, tile_x: int = 16, lean: bool = True,
                 kernel: str = "flat"):
        super().__init__()
        b = base
        require_homogeneous(b, "PaddedLinearWave")
        if kernel not in ("flat", "3d"):
            raise ValueError(f"kernel = {kernel!r}: 'flat' or '3d'")
        self.base = b
        self.kernel = "3d" if kernel == "3d" or b.p > 8 else "flat"
        shape = tuple(n * b.p + 1 for n in b.mesh.shape)
        if self.kernel == "flat":
            self.layout = PaddedLayout(
                shape=shape, p=b.p, tile_x=_flat_tile_x(b.p, tile_x), z_align=16
            )
            self.layout.check_flat()
        else:
            self.layout = PaddedLayout(shape=shape, p=b.p, tile_x=tile_x)
            check_slab(self.layout)
        self._m_lines = [
            lumped_weight_line(b.mesh.shape[d], b.p, b.mesh.h[d])
            for d in range(3)
        ]
        A, _ = separable_stiffness_tables(b.p, b.mesh.h, b.dtype)
        lines = grid_lines(b.mesh.shape, b.p, b.dtype)
        coeff = -float(b.c0) ** 2
        if self.kernel == "flat":
            self._register("flat", FlatTables, build_tables_flat(
                self.layout, A, lines, coeff, self._m_lines, b.dtype))
            self._register("stencil", StencilTables, stencil_tables(
                self.layout, A, lines, coeff, self._m_lines, b.dtype))
        else:
            self._register("slab", SlabTables, build_tables(
                self.layout, A, lines, coeff, self._m_lines, b.dtype))

        self._planes = []  # (axis, padded index, 'w1'|'w2')
        for i, (axis, pidx, attr, plane) in enumerate(self._build_boundary_planes()):
            self._planes.append((axis, pidx, attr))
            self.register_buffer(f"plane_{i}", self._tensor(plane))

        # the kernel paths: the flat layout, x-face source/ABC planes, and
        # for the step kernels a tile that holds their slab halo (the JAX
        # package's conditions, kept so both packages take the same path)
        self.lean = lean
        self._work = None
        if self.kernel != "flat":
            self.stage_unavailable = self.step_unavailable = _NEEDS_FLAT
            self.lf_unavailable = self.lf2_unavailable = _NEEDS_FLAT
            self.rk42_unavailable = _NEEDS_FLAT
            return
        planes = _x_face_planes(self)
        self.stage_unavailable = None if planes is not None else _NO_X_FACES
        self.step_unavailable = self._unavailable(planes, _off0(b.p), "3p")
        self.lf_unavailable = self._unavailable(planes, lfstep._off0(b.p), "2p")
        self.lf2_unavailable = self._unavailable(planes, lf2step._off0(b.p), "3p")
        self.rk42_unavailable = self._unavailable(planes, rk42step._off0(b.p), "6p")
        if planes is not None:
            w1, w2, self.src_x, self.abc_x = planes
            F = w1.size
            self.register_buffer("face_w1", self._tensor(w1.reshape(1, F)))
            self.register_buffer("face_w2", self._tensor(w2.reshape(1, F)))
            args = (self.layout, A, lines, coeff, self._m_lines,
                    w1, w2, self.src_x, self.abc_x)
            for prefix, kind, build, unavailable in (
                ("step", StepTables, build_step_tables, self.step_unavailable),
                ("lf", LFTables, build_lf_tables, self.lf_unavailable),
                ("lf2", LF2Tables, build_lf2_tables, self.lf2_unavailable),
            ):
                if unavailable is None:
                    self._register(prefix, kind, build(*args, dtype=b.dtype))

    def _unavailable(self, planes, off0: int, halo: str) -> str | None:
        """Why a step kernel with slab halo ``off0`` does not apply, or None."""
        if self.layout.tile_x < off0:
            return f"tile_x = {self.layout.tile_x} < the {halo} slab halo {off0}"
        if planes is None:
            return _NO_X_FACES
        return None

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        """A NumPy table of the model's dtype (``convert.as_table``) as a
        tensor on the model's device."""
        return tables_from_numpy((a,), self.base.device, self.base.dtype)[0]

    def _register(self, prefix, kind, arrays):
        for name, a in zip(kind._fields, arrays):
            self.register_buffer(f"{prefix}_{name}", self._tensor(a))

    def _tables(self, prefix, kind):
        return kind(*(getattr(self, f"{prefix}_{n}") for n in kind._fields))

    @property
    def flat_tables(self) -> FlatTables | None:
        return self._tables("flat", FlatTables) if self.kernel == "flat" else None

    @property
    def stencil(self) -> StencilTables | None:
        return self._tables("stencil", StencilTables) if self.kernel == "flat" else None

    @property
    def slab_tables(self) -> SlabTables | None:
        return self._tables("slab", SlabTables) if self.kernel == "3d" else None

    @property
    def step_tables(self) -> StepTables | None:
        if self.step_unavailable is not None:
            return None
        return self._tables("step", StepTables)

    @property
    def lf_tables(self) -> LFTables | None:
        if self.lf_unavailable is not None:
            return None
        return self._tables("lf", LFTables)

    @property
    def lf2_tables(self) -> LF2Tables | None:
        if self.lf2_unavailable is not None:
            return None
        return self._tables("lf2", LF2Tables)

    def _build_boundary_planes(self):
        """[(axis, padded index, 'w1'|'w2', plane)] with the 2D planes
        premultiplied by 1/m and padded to the padded dims of their axes."""
        b = self.base
        lay = self.layout
        m3 = np.einsum("i,j,k->ijk", *self._m_lines)
        tags = b.mesh.facet_tags
        out = []
        npdt = table_dtype(b.dtype)
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
        """-c0^2 (K u)/m on the padded state (on a CUDA tensor kernel B, or
        kernel E on the 3D-slab layout)."""
        if self.kernel == "3d":
            return apply_slab(u, self.layout, self.slab_tables)
        return apply_flat(u, self.layout, self.flat_tables, self.stencil)

    def f1(self, t, u, v):
        b = self.base
        kv = self._apply(u)
        for axis, pidx, attr, plane in self._boundary_planes:
            if attr == "w1":
                kv[pidx] += b._g(t) * plane
            else:
                kv[pidx] += -b.c0 * plane * v[pidx]
        return kv

    def f0(self, t, u, v):
        return v

    # -- leapfrog decomposition: f1 = force(t, u) - damping * v ---------
    def force(self, t, u):
        """v-independent part of f1 (solvers/leapfrog.py split)."""
        b = self.base
        kv = self._apply(u)
        for axis, pidx, attr, plane in self._boundary_planes:
            if attr == "w1":
                kv[pidx] += b._g(t) * plane
        return kv

    @property
    def damping(self) -> torch.Tensor:
        """Diagonal ABC damping D = c0 W2/m as a padded state."""
        damp = torch.zeros(self.layout.padded_shape, dtype=self.base.dtype,
                           device=self.base.device)
        for axis, pidx, attr, plane in self._boundary_planes:
            if attr == "w2":
                damp[pidx] += self.base.c0 * plane
        return damp

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
        """The kernels' buffers, allocated once per model: two ping-pong
        state pairs and six state-sized scratch fields (kernel A: kv0..kv2;
        H: v+; I: u1, v+1, v+2; D: two vn and two kv; J: kv0..kv2, u1, v1,
        kv0')."""
        if self._work is None:
            e = lambda: torch.empty(  # noqa: E731
                self.layout.padded_shape, dtype=self.base.dtype,
                device=self.base.device)
            self._work = ((e(), e()), (e(), e())), tuple(e() for _ in range(6))
        return self._work

    def _kernel_buffers(self, u):
        """(pairs, scratch) for a solve from state ``u``: the workspace on
        the card, Nones on the CPU (the plain versions allocate)."""
        if u.device.type == "cuda":
            return self._workspace()
        return (None, None), (None,) * 6

    @staticmethod
    def _handout(u, v):
        """Copies of a solve's result that the next solve will not
        overwrite (CUDA results live in the workspace)."""
        if u.device.type == "cuda":
            return u.clone(), v.clone()
        return u, v

    def _require(self, unavailable: str | None, what: str) -> None:
        if unavailable is not None:
            raise ValueError(f"{what} unavailable for this config ({unavailable})")

    def solve_step_n(self, t0, dt, nsteps, u0=None, v0=None):
        """RK4 with one step-kernel call per timestep (kernel A, or C with
        ``lean=False``); returns (u, v, nsteps).

        Raises ValueError when the step path does not apply to this
        configuration (no fallback to another solver)."""
        self._require(self.step_unavailable, "fused RK4 step kernel")
        with annotate("wave.rk4.solve"):
            if u0 is None:
                u0, v0 = self.zero_state()
            pairs, scratch = self._kernel_buffers(u0)
            u, v = self._rk4_steps(u0, v0, float(t0), float(dt), nsteps, pairs,
                                   scratch)
            return (*self._handout(u, v), nsteps)

    def _rk4_steps(self, u, v, t, dtf, nsteps, pairs, scratch, first=0):
        """``nsteps`` step-kernel steps (A, or C with ``lean=False``) from
        (u, v) at time t; step i writes ``pairs[i % 2]`` for i from
        ``first`` on (ping-pong: a step never writes the pair it reads)."""
        b = self.base
        step = rk4_step_lean if self.lean else rk4_step_full
        tables, stencil = self.step_tables, self.stencil
        for i in range(first, first + nsteps):
            with annotate("wave.rk4.step"):
                gs = [b.g_amplitude(t + c * dtf) for c in _RK_C]
                u, v = step(
                    u, v, dtf, gs, self.layout, b.c0, tables, stencil,
                    self.src_x, self.abc_x, out=pairs[i % 2], scratch=scratch[:3],
                )
            t = t + dtf
        return u, v

    def solve_step2_n(self, t0, dt, nsteps, u0=None, v0=None):
        """RK4 with two full-tableau steps per kernel call (kernel J, seven
        launches per call; the same scheme as :meth:`solve_step_n`); an odd
        last step runs through the step kernel ``lean`` selects (A, or C).
        Returns (u, v, nsteps); raises ValueError when the path does not
        apply."""
        self._require(self.rk42_unavailable, "fused 2-step RK4 kernel")
        if u0 is None:
            u0, v0 = self.zero_state()
        b = self.base
        dtf = float(dt)
        t = float(t0)
        pairs, scratch = self._kernel_buffers(u0)
        stencil = self.stencil
        u, v = u0, v0
        for i in range(nsteps // 2):
            gs = [b.g_amplitude(t + j * 0.5 * dtf) for j in range(5)]
            u, v = rk42_step(
                u, v, dtf, gs, self.layout, b.c0, stencil, self.face_w1,
                self.face_w2, self.src_x, self.abc_x, out=pairs[i % 2],
                scratch=scratch,
            )
            t = t + 2 * dtf
        if nsteps % 2:
            u, v = self._rk4_steps(u, v, t, dtf, 1, pairs, scratch,
                                   first=nsteps // 2)
        return (*self._handout(u, v), nsteps)

    def solve_fused_n(self, t0, dt, nsteps, u0=None, v0=None):
        """RK4 with one fused stage-kernel call per stage (kernel D: the
        stiffness, the stage axpys and the x-face planes in one pass);
        returns (u, v, nsteps). Raises ValueError when the stage path does
        not apply."""
        self._require(self.stage_unavailable, "fused RK4 stage kernel")
        if u0 is None:
            u0, v0 = self.zero_state()
        b = self.base
        dtf = float(dt)
        t = float(t0)
        pairs, scratch = self._kernel_buffers(u0)
        flat, stencil = self.flat_tables, self.stencil
        u, v = u0, v0
        for i in range(nsteps):
            # the carry of the JAX package's solve_fused_n: stage 0 starts
            # from ku, kv = u, v with ca = 0; the step accumulates into the
            # pair it does not read, and vn/kv' ping-pong in the scratch
            ku, kv = u, v
            ua, va = u, v
            for j in range(4):
                out = None
                if scratch[0] is not None:
                    out = (scratch[j % 2], scratch[2 + j % 2], *pairs[i % 2])
                vn, kv, ua, va = rk_stage(
                    u, ku, v, kv, ua, va, dtf * _RK_A[j], dtf * _RK_B[j],
                    b.g_amplitude(t + _RK_C[j] * dtf), self.layout, b.c0,
                    flat, stencil, self.face_w1, self.face_w2, self.src_x,
                    self.abc_x, out=out,
                )
                ku = vn
            u, v = ua, va
            t = t + dtf
        return (*self._handout(u, v), nsteps)

    def solve_lf_n(self, t0, dt, nsteps, u0=None, v0=None):
        """Leapfrog with one step-kernel call per step (kernel H:
        kick-drift-kick, semi-implicit ABC damping, solvers/leapfrog.py
        semantics); dt must satisfy the leapfrog CFL (about 0.71x the RK4
        step). Returns (u, v, nsteps); raises ValueError when the path does
        not apply."""
        self._require(self.lf_unavailable, "fused leapfrog step kernel")
        if u0 is None:
            u0, v0 = self.zero_state()
        dtf = float(dt)
        pairs, scratch = self._kernel_buffers(u0)
        u, v = self._lf_steps(u0, v0, float(t0), dtf, nsteps, pairs, scratch)
        return (*self._handout(u, v), nsteps)

    def _lf_steps(self, u, v, t, dtf, nsteps, pairs, scratch, first=0):
        """``nsteps`` kernel-H steps from (u, v) at time t; step i writes
        ``pairs[i % 2]`` for i from ``first`` on."""
        b, tables, stencil = self.base, self.lf_tables, self.stencil
        for i in range(first, first + nsteps):
            with annotate("wave.lf.step"):
                u, v = lf_step(
                    u, v, dtf, b.g_amplitude(t), b.g_amplitude(t + dtf),
                    self.layout, b.c0, tables, stencil, self.src_x, self.abc_x,
                    out=pairs[i % 2], scratch=scratch[0],
                )
            t = t + dtf
        return u, v

    def solve_lf2_n(self, t0, dt, nsteps, u0=None, v0=None):
        """Leapfrog with two steps per kernel call (kernel I; same scheme
        and CFL as :meth:`solve_lf_n`); an odd last step runs through kernel
        H. Returns (u, v, nsteps); raises ValueError when the path does not
        apply."""
        self._require(self.lf2_unavailable, "fused 2-step leapfrog kernel")
        with annotate("wave.lf2.solve"):
            if u0 is None:
                u0, v0 = self.zero_state()
            b = self.base
            dtf = float(dt)
            t = float(t0)
            pairs, scratch = self._kernel_buffers(u0)
            tables, stencil = self.lf2_tables, self.stencil
            u, v = u0, v0
            for i in range(nsteps // 2):
                with annotate("wave.lf2.call"):
                    u, v = lf2_step(
                        u, v, dtf, b.g_amplitude(t), b.g_amplitude(t + dtf),
                        b.g_amplitude(t + 2 * dtf), self.layout, b.c0, tables,
                        stencil, self.src_x, self.abc_x, out=pairs[i % 2],
                        scratch=scratch[:3],
                    )
                t = t + 2 * dtf
            if nsteps % 2:
                u, v = self._lf_steps(u, v, t, dtf, 1, pairs, scratch,
                                      first=nsteps // 2)
            return (*self._handout(u, v), nsteps)


def _x_face_planes(pm: PaddedLinearWave):
    """(w1_flat, w2_flat, src_x, abc_x) if all tagged faces are x-faces with
    exactly one source and one absorbing plane; None otherwise."""
    w1 = w2 = None
    src_x = abc_x = None
    for axis, pidx, attr, plane in pm._boundary_planes:
        if axis != 0:
            return None
        row = pidx[0]
        host = plane.cpu()
        if host.dtype == torch.bfloat16:  # NumPy has no bf16: exact in f64
            host = host.double()
        if attr == "w1":
            if w1 is not None:
                return None
            w1, src_x = host.numpy().ravel(), row
        else:
            if w2 is not None:
                return None
            w2, abc_x = host.numpy().ravel(), row
    if w1 is None or w2 is None:
        return None
    return w1, w2, src_x, abc_x
