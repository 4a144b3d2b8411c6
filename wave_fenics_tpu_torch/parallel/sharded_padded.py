"""The padded-layout solvers, distributed over blocks.

Port of ``wave_fenics_tpu.parallel.sharded_padded``. Two schemes:

- **per-stage halo-add** (:meth:`ShardedPaddedWave.solve_n`): per RK4
  stage, the padded stiffness/m of each block (kernel B on the flat
  layout, kernel E on the 3D-slab layout the JAX package takes for
  ``kernel='3d'`` or p > 8), its boundary planes, then one halo-add sweep
  of the interface planes. Each block's tables are built as if its part
  had domain faces: the halo-add of the one-sided partial sums rebuilds
  the full stencil on the interface dofs. 1/m divides by the global mass
  lines' slices (division commutes with the sum), and the boundary planes
  are added before the halo-add, so shared face edges sum their facet
  terms across blocks. The JAX package's ``overlap_x`` (the x-interface
  planes formed from u by a slab formula and exchanged before the
  interior launch) has no counterpart: the port's exchange completes
  before the next launch, so it would overlap nothing; both of the JAX
  settings give this path's result;
- **value halo** (:meth:`solve_step_n` on kernel A, :meth:`solve_lf_n` on
  kernel H, :meth:`solve_lf2_n` on kernel I, :meth:`solve_step2_n` on
  kernel J): the blocks live in layouts with a halo of 3p, 2p, 3p and 6p
  that holds the neighbours' values, refreshed once per kernel call
  (:func:`halo.refresh_value_halos`); the tables are slices of the global
  assembled coefficients with that halo, so a block computes the whole
  stencil on its own rows and no partial sum is exchanged. The kernels
  write each launch over the interior grown into the halo as deep as the
  next launch reads (``ops.rk4step.stage_rings``, ``ops.lfstep.
  phase_rings``, ``ops.rk42step.call_rings``); J's plain version computes
  the same boxes, A's, H's and I's what the TPU kernels compute.

Each block's tables are built from the lumped weight lines rounded to
the model's dtype, as one device's are (``grid_lines``), and rounded once
more where they are stored; the JAX package's blocks take the lines
unrounded, so in bf16 and float32 its blocks differ from its one device
in every row (a fault of the reference, ROADMAP Queue 3). A value-halo
refresh copies values, so those paths give one device's state bit for
bit, bf16 included; the per-stage halo-add sums two partial planes with
one rounding each (as the JAX package does), so that path differs from
one device by that rounding.

Where a path does not apply, its solver raises a ValueError that names
the condition (``step_unavailable``, ``lf_unavailable``,
``lf2_unavailable``, ``step2_unavailable``); the JAX ``solve_step_n``
falls back to ``solve_n`` instead, and the app makes that choice itself.
"""

from __future__ import annotations

from functools import cached_property

import numpy as np
import torch

from ..convert import tables_from_numpy
from ..core.basis import lumped_weight_line
from ..core.mesh import BOX_FACETS
from ..models.linear_wave import LinearWave, require_homogeneous
from ..models.linear_wave_padded import _RK_C, _flat_tile_x
from ..ops import lf2step, lfstep, rk42step, rk4step
from ..ops.separable import grid_lines, separable_stiffness_tables
from ..ops.stiffness import banded_1d_coeffs
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
    stencil_tables,
    stencil_tables_from_cv,
)
from ..solvers.rk4 import rk4_solve_n
from .halo import Exchange, LocalExchange, halo_add, refresh_value_halos
from .partition import Blocks, per_block
from .sharded_wave import block_mesh

__all__ = ["ShardedPaddedWave"]

# (module, tables, the function that builds them, halo in units of p) of
# the value-halo paths; the step2 path's tables are the stencil's and the
# face planes (kernel J's plain version runs on them too)
_PATHS = {
    "step": (rk4step, rk4step.StepTables, rk4step.build_step_tables_from_cv, 3),
    "lf": (lfstep, lfstep.LFTables, lfstep.build_lf_tables_from_cv, 2),
    "lf2": (lf2step, lf2step.LF2Tables, lf2step.build_lf2_tables_from_cv, 3),
    "step2": (rk42step, None, None, 6),
}


class ShardedPaddedWave:
    """``PaddedLinearWave``'s solvers on an (mx, my, mz) grid of blocks.
    ``tile_x`` and ``kernel`` are the JAX class's; ``devices``/``device``
    place the blocks (``partition.make_device_mesh``; by default the
    model's device type), ``exchange`` moves the slabs (default
    ``halo.LocalExchange``). States are :class:`partition.Blocks` of padded
    blocks: :meth:`zero_state` and the ``*_step``/``*_lf``/``*_lf2``
    variants give each path's layout."""

    def __init__(self, model: LinearWave, parts, tile_x: int = 16, devices=None,
                 kernel: str = "flat", device=None,
                 exchange: Exchange | None = None):
        if kernel not in ("flat", "3d"):
            raise ValueError(f"kernel = {kernel!r}: 'flat' or '3d'")
        require_homogeneous(model, "ShardedPaddedWave")
        self.model = model
        self.parts = tuple(int(m) for m in parts)
        for n, m in zip(model.mesh.shape, self.parts):
            if n % m != 0:
                raise ValueError(
                    f"cells {model.mesh.shape} not divisible by {self.parts}")
        self.tile_x = tile_x
        # the flat kernel's 8-deep halo windows hold p <= 8
        self.kernel = "3d" if kernel == "3d" or model.p > 8 else "flat"
        self.mesh = block_mesh(model, self.parts, devices, device, exchange)
        self.exchange = exchange if exchange is not None else LocalExchange(self.mesh)
        self.local_cells = tuple(n // m for n, m in zip(model.mesh.shape, self.parts))
        self._work = {}
        self._halo_tabs = {}

    # -- geometry ---------------------------------------------------------
    @cached_property
    def layout(self) -> PaddedLayout:
        p = self.model.p
        shape = tuple(n * p + 1 for n in self.local_cells)
        if self.kernel == "flat":
            lay = PaddedLayout(shape=shape, p=p, tile_x=_flat_tile_x(p, self.tile_x),
                               z_align=16)
            lay.check_flat()
        else:
            lay = PaddedLayout(shape=shape, p=p, tile_x=self.tile_x)
            check_slab(lay)
        return lay

    @property
    def _own(self) -> list[int]:
        return self.exchange.local_blocks

    def _per_block(self, fn) -> Blocks:
        """Blocks of ``fn(b, coords, device)`` on the held blocks."""
        return per_block(self.mesh, self._own, fn)

    def _tensor(self, a, dev) -> torch.Tensor:
        """A float64 table as a tensor of the model's dtype on ``dev``
        (bf16: rounded once)."""
        return tables_from_numpy((a,), dev, self.model.dtype)[0]

    @cached_property
    def _global_m_lines(self) -> list[np.ndarray]:
        gm = self.model.mesh
        return [lumped_weight_line(gm.shape[d], self.model.p, gm.h[d]) for d in range(3)]

    def _m_slice(self, axis: int, b: int) -> np.ndarray:
        p = self.model.p
        nl = self.local_cells[axis]
        start = b * nl * p
        return self._global_m_lines[axis][start : start + nl * p + 1]

    # -- per-block tables of the per-stage path ---------------------------
    @cached_property
    def _tables(self) -> Blocks:
        """Each block's stiffness/m tables: (FlatTables, StencilTables) on
        the flat layout, the plain version's on the CPU and the kernel's on
        a card (the other None), or SlabTables on the 3D-slab layout."""
        md = self.model
        p = md.p
        lay = self.layout
        A, _ = separable_stiffness_tables(p, md.mesh.h, md.dtype)
        local_lines = grid_lines(self.local_cells, p, md.dtype)
        coeff = -float(md.c0) ** 2

        def build(b, c, dev):
            m_lines = [self._m_slice(d, c[d]) for d in range(3)]
            args = (lay, A, local_lines, coeff, m_lines, md.dtype)
            if self.kernel == "3d":
                return SlabTables(*(self._tensor(t, dev) for t in build_tables(*args)))
            if dev.type == "cpu":
                return FlatTables(*(self._tensor(t, dev)
                                    for t in build_tables_flat(*args))), None
            return None, StencilTables(*(self._tensor(t, dev)
                                         for t in stencil_tables(*args)))

        return self._per_block(build)

    def _apply(self, b: int, u: torch.Tensor) -> torch.Tensor:
        """-c0^2 (K u)/m on block b (kernel B or E on a card)."""
        if self.kernel == "3d":
            return apply_slab(u, self.layout, self._tables[b])
        flat, st = self._tables[b]
        return apply_flat(u, self.layout, flat, st)

    # -- boundary planes (only on the blocks at a tagged face) -------------
    @cached_property
    def _boundary_planes(self) -> Blocks:
        """Per block [(padded index, 'w1'|'w2', plane)]: the local lumped
        facet weights over the block's slice of each tagged face, divided by
        the global mass (the halo-add sums the shared-edge contributions);
        blocks away from the face hold none (the JAX package's zero planes)."""
        md = self.model
        lay = self.layout
        p = md.p
        m3 = self._global_m_lines

        def build(b, c, dev):
            out = []
            for tag, attr in ((md.source_tag, "w1"), (md.abc_tag, "w2")):
                for fid in md.mesh.facet_tags.facets_of(tag):
                    axis, side = BOX_FACETS[fid]
                    if c[axis] != (0 if side == 0 else self.parts[axis] - 1):
                        continue
                    oth = [d for d in range(3) if d != axis]
                    nl0 = self.local_cells[oth[0]] * p + 1
                    nl1 = self.local_cells[oth[1]] * p + 1
                    lines = [lumped_weight_line(self.local_cells[a], p, md.mesh.h[a])
                             for a in oth]
                    wloc = np.outer(lines[0], lines[1])
                    mseg = np.outer(self._m_slice(oth[0], c[oth[0]]),
                                    self._m_slice(oth[1], c[oth[1]]))
                    mface = m3[axis][0 if side == 0 else -1]
                    pp = np.zeros((lay.padded_shape[oth[0]], lay.padded_shape[oth[1]]))
                    o0 = lay.x0 if oth[0] == 0 else lay.h
                    o1 = lay.h
                    pp[o0 : o0 + nl0, o1 : o1 + nl1] = wloc / (mseg * mface)
                    pidx = [slice(None)] * 3
                    off = lay.x0 if axis == 0 else lay.h
                    n_ax = self.local_cells[axis] * p + 1
                    pidx[axis] = off if side == 0 else off + n_ax - 1
                    out.append((tuple(pidx), attr, self._tensor(pp, dev)))
            return out

        return self._per_block(build)

    # -- physics ----------------------------------------------------------
    def _interface_planes(self) -> list[tuple[int, int]]:
        lay = self.layout
        offs = (lay.x0, lay.h, lay.h)
        return [(o, o + n - 1) for o, n in zip(offs, lay.shape)]

    def _f1(self, t: float, u: Blocks, v: Blocks) -> Blocks:
        md = self.model
        kv = Blocks([None] * len(u))
        g = md._g(t)
        for b in self._own:
            kv[b] = self._apply(b, u[b])
            for pidx, attr, plane in self._boundary_planes[b]:
                if attr == "w1":
                    kv[b][pidx] += g * plane
                else:
                    kv[b][pidx] += -md.c0 * plane * v[b][pidx]
        return halo_add(kv, self.exchange, self._interface_planes())

    # -- states -------------------------------------------------------------
    def zero_blocks(self, lay: PaddedLayout) -> Blocks:
        """Zero blocks in ``lay``."""
        return self._per_block(lambda b, c, dev: torch.zeros(
            lay.padded_shape, dtype=self.model.dtype, device=dev))

    def zero_state(self) -> tuple[Blocks, Blocks]:
        return self.zero_blocks(self.layout), self.zero_blocks(self.layout)

    def solve(self, t0, tf, dt, u0=None, v0=None):
        return self.solve_n(t0, dt, int(round((tf - t0) / dt)), u0, v0)

    def solve_n(self, t0, dt, nsteps, u0=None, v0=None):
        """RK4 with the per-stage halo-add (kernel B, or E on the 3D-slab
        layout, four launches per step on each block); returns (u, v,
        nsteps)."""
        if u0 is None:
            u0, v0 = self.zero_state()
        u, v = rk4_solve_n(lambda t, u, v: v, self._f1, Blocks(u0), Blocks(v0),
                           t0, dt, nsteps)
        return u, v, nsteps

    # -- the value-halo paths ----------------------------------------------
    @cached_property
    def value_halo_unavailable(self) -> str | None:
        """Why the value-halo paths (step, lf, lf2) do not apply, or None:
        the JAX package's conditions, which the three share."""
        if self.kernel != "flat":
            return "needs the flat layout (kernel='3d' or p > 8)"
        # one-hop refresh: a block must supply a neighbour's whole halo from
        # rows that are themselves valid to that depth; one cell a block on
        # an axis split 3 or more ways sends its own stale halo rows
        if any(m >= 3 and n < 2 for n, m in zip(self.local_cells, self.parts)):
            return ("needs >= 2 cells a block on every axis split >= 3 ways (the "
                    "one-hop value-halo refresh)")
        md = self.model
        faces = {}
        for tag, attr in ((md.source_tag, "w1"), (md.abc_tag, "w2")):
            fl = md.mesh.facet_tags.facets_of(tag)
            if len(fl) != 1 or BOX_FACETS[fl[0]][0] != 0:
                faces = None
                break
            faces[attr] = BOX_FACETS[fl[0]][1]
        if faces is None or faces.get("w1") != 0 or faces.get("w2") != 1:
            return "needs one source plane on x-low and one absorbing plane on x-high"
        return None

    @property
    def step_unavailable(self) -> str | None:
        return self.value_halo_unavailable

    lf_unavailable = lf2_unavailable = step_unavailable

    @property
    def step2_unavailable(self) -> str | None:
        """Why the 2-step RK4 path does not apply, or None: the value-halo
        paths' conditions and the JAX package's one-hop guard scaled to the
        6p halo, >= 5 cells a block on every axis split >= 3 ways."""
        why = self.value_halo_unavailable
        if why is None and any(m >= 3 and n < 5
                               for n, m in zip(self.local_cells, self.parts)):
            why = ("needs >= 5 cells a block on every axis split >= 3 ways (the "
                   "one-hop 6p value-halo refresh)")
        return why

    def halo_layout(self, path: str) -> PaddedLayout:
        """The value-halo layout of ``path``: halo 3p ('step', 'lf2'), 2p
        ('lf') or 6p ('step2'), the tile the JAX package takes (a multiple
        of p and 8, at least the TPU kernel's slab halo)."""
        mod, _, _, k = _PATHS[path]
        p = self.model.p
        shape = tuple(n * p + 1 for n in self.local_cells)
        tx = _flat_tile_x(p, max(self.tile_x, mod._off0(p)))
        return PaddedLayout(shape=shape, p=p, tile_x=tx, z_align=16, halo=k * p)

    def _embed_global(self, gvec: np.ndarray, axis: int, b: int,
                      lay: PaddedLayout) -> np.ndarray:
        """A global per-dof axis vector sliced for block ``b`` with its value
        halo, at the block's padded offsets (zeros outside the domain)."""
        h = lay.h
        off = lay.x0 if axis == 0 else lay.h
        L = lay.padded_shape[axis]
        Nloc = lay.shape[axis]
        g0 = b * (Nloc - 1)
        out = np.zeros(gvec.shape[:-1] + (L,), dtype=gvec.dtype)
        lo = max(0, g0 - h)
        hi = min(gvec.shape[-1], g0 + Nloc + h)
        out[..., off - (g0 - lo) : off + (hi - g0)] = gvec[..., lo:hi]
        return out

    @cached_property
    def _global_cv(self) -> tuple[list[np.ndarray], list[np.ndarray]]:
        """The global assembled coefficients of the value-halo paths: per
        axis the banded stiffness coefficients over m, and the lumped lines
        over m, from the lines rounded to the model's dtype as one device
        rounds them (``grid_lines``), so each block's tables hold one
        device's values."""
        md = self.model
        p = md.p
        coeff = -float(md.c0) ** 2
        A, _ = separable_stiffness_tables(p, md.mesh.h, md.dtype)
        glines = grid_lines(md.mesh.shape, p, md.dtype)
        ginv = [1.0 / m for m in self._global_m_lines]
        gcvs = [banded_1d_coeffs(A[d], n * p + 1, p, scale=coeff) * ginv[d][None, :]
                for d, n in enumerate(md.mesh.shape)]
        return gcvs, [glines[d] * ginv[d] for d in range(3)]

    def _halo_tables(self, path: str) -> Blocks:
        """Per block (tables, stencil or None, src_x, abc_x) of a value-halo
        path: the JAX package's tables from the global assembled
        coefficients (``build_*_tables_from_cv`` on :attr:`_global_cv`),
        and on a card the
        kernels' stencil tables from the same vectors; for 'step2', the
        [1, F] face planes (w1, w2) and the stencil on every device;
        ``src_x``/``abc_x`` the padded rows of the global x faces, -1 on a
        block that does not reach them."""
        if path in self._halo_tabs:
            return self._halo_tabs[path]
        why = self.step2_unavailable if path == "step2" else self.value_halo_unavailable
        if why is not None:
            raise ValueError(f"value-halo {path} path unavailable for this "
                             f"configuration ({why})")
        md = self.model
        p = md.p
        lay = self.halo_layout(path)
        _, kind, build_tables_from_cv, _ = _PATHS[path]
        gshape = tuple(n * p + 1 for n in md.mesh.shape)
        gcvs, gsl = self._global_cv
        ginv = [1.0 / m for m in self._global_m_lines]
        w_y = lumped_weight_line(md.mesh.shape[1], p, md.mesh.h[1]) * ginv[1]
        w_z = lumped_weight_line(md.mesh.shape[2], p, md.mesh.h[2]) * ginv[2]
        mx_line = self._global_m_lines[0]
        h = lay.h

        def build(b, c, dev):
            bx, by, bz = c
            cvx = self._embed_global(gcvs[0], 0, bx, lay)
            cvy = self._embed_global(gcvs[1], 1, by, lay)
            cvz = self._embed_global(gcvs[2], 2, bz, lay)
            pLx = self._embed_global(gsl[0], 0, bx, lay)
            pLy = self._embed_global(gsl[1], 1, by, lay)
            pLz = self._embed_global(gsl[2], 2, bz, lay)
            py = self._embed_global(w_y, 1, by, lay)
            pz = self._embed_global(w_z, 2, bz, lay)
            w1 = np.outer(py / mx_line[0], pz).ravel()
            w2 = np.outer(py / mx_line[-1], pz).ravel()
            Nloc = lay.shape[0]
            g0 = bx * (Nloc - 1)

            def prow(g):
                r = g - g0
                return lay.x0 + r if -h <= r < Nloc + h else -1

            src_x, abc_x = prow(0), prow(gshape[0] - 1)
            st = None
            if path == "step2":
                tables = tuple(self._tensor(w.reshape(1, -1), dev) for w in (w1, w2))
            else:
                tables = kind(*(self._tensor(t, dev) for t in build_tables_from_cv(
                    lay, cvx, cvy, cvz, pLx, pLy, pLz, w1, w2, src_x, abc_x, md.dtype)))
            if dev.type == "cuda" or path == "step2":
                st = StencilTables(*(self._tensor(t, dev) for t in stencil_tables_from_cv(
                    lay, cvx, cvy, cvz, pLx, pLy, pLz, md.dtype)))
            return tables, st, src_x, abc_x

        out = self._halo_tabs[path] = self._per_block(build)
        return out

    def refresh(self, blocks: Blocks, lay: PaddedLayout) -> Blocks:
        """Refresh the value halo of a state in ``lay`` in place
        (:func:`halo.refresh_value_halos`, depth ``lay.h``)."""
        return refresh_value_halos(blocks, self.exchange, (lay.x0, lay.h, lay.h),
                                   lay.shape, lay.h)

    def _workspace(self, path: str, lay: PaddedLayout, nscratch: int):
        """Per block, the kernels' buffers on a card: two ping-pong state
        pairs and ``nscratch`` scratch fields (None on the CPU, where the
        plain versions allocate)."""
        if path not in self._work:
            def make(b, c, dev):
                if dev.type != "cuda":
                    return None
                e = lambda: torch.empty(lay.padded_shape,  # noqa: E731
                                        dtype=self.model.dtype, device=dev)
                return ((e(), e()), (e(), e())), tuple(e() for _ in range(nscratch))
            self._work[path] = self._per_block(make)
        return self._work[path]

    def _start(self, path, lay, nscratch, u0, v0):
        """The working pair of a value-halo solve: a copy of (u0, v0) (the
        refresh writes the halo in place) or zeros, in the pair step 0 does
        not write."""
        work = self._workspace(path, lay, nscratch)
        u, v = Blocks([None] * self.mesh.nblocks), Blocks([None] * self.mesh.nblocks)
        for b in self._own:
            src = (None, None) if u0 is None else (u0[b], v0[b])
            if src[0] is not None and tuple(src[0].shape) != lay.padded_shape:
                raise ValueError(f"a state of block shape {tuple(src[0].shape)}: the "
                                 f"{path} path's layout is {lay.padded_shape} "
                                 f"(zero_state_{path} or from_global(grid, "
                                 f"halo_layout('{path}')))")
            if work[b] is None:
                u[b] = torch.zeros(lay.padded_shape, dtype=self.model.dtype,
                                   device=self.mesh.devices[b]) if src[0] is None \
                    else src[0].clone()
                v[b] = torch.zeros_like(u[b]) if src[1] is None else src[1].clone()
            else:
                uu, vv = work[b][0][1]
                if src[0] is None:
                    uu.zero_(), vv.zero_()
                else:
                    uu.copy_(src[0]), vv.copy_(src[1])
                u[b], v[b] = uu, vv
        return work, u, v

    @staticmethod
    def _handout(u: Blocks, v: Blocks):
        """Copies of a result that the next solve will not overwrite."""
        return (Blocks(None if x is None else x.clone() if x.is_cuda else x for x in u),
                Blocks(None if x is None else x.clone() if x.is_cuda else x for x in v))

    def _steps(self, path, nscratch, calls, call_dt, step_fn, t0, u0, v0):
        """``calls`` kernel calls of a value-halo path from time t0: per
        call, refresh u and v, then ``step_fn(lay, tables, u, v, t, out,
        scratch)`` on every held block (ping-ponging the workspace pairs),
        then t += call_dt, as the JAX package accumulates it."""
        lay = self.halo_layout(path)
        tabs = self._halo_tables(path)
        work, u, v = self._start(path, lay, nscratch, u0, v0)
        t = float(t0)
        for i in range(calls):
            self.refresh(u, lay)
            self.refresh(v, lay)
            un, vn = Blocks([None] * len(u)), Blocks([None] * len(v))
            for b in self._own:
                out = scratch = None
                if work[b] is not None:
                    out, scratch = work[b][0][i % 2], work[b][1]
                un[b], vn[b] = step_fn(lay, tabs[b], u[b], v[b], t, out, scratch)
            u, v = un, vn
            t = t + call_dt
        return self._handout(u, v)

    def zero_state_step(self):
        lay = self.halo_layout("step")
        return self.zero_blocks(lay), self.zero_blocks(lay)

    def zero_state_lf(self):
        lay = self.halo_layout("lf")
        return self.zero_blocks(lay), self.zero_blocks(lay)

    def zero_state_lf2(self):
        lay = self.halo_layout("lf2")
        return self.zero_blocks(lay), self.zero_blocks(lay)

    def solve_step_n(self, t0, dt, nsteps, u0=None, v0=None):
        """RK4 with one value-halo refresh and one call of the step kernel
        per step (kernel A: four stage launches a block); returns (u, v,
        nsteps). Raises a ValueError where the path does not apply."""
        md = self.model
        dtf = float(dt)

        def step(lay, tab, u, v, t, out, scratch):
            tables, st, src_x, abc_x = tab
            gs = [md.g_amplitude(t + c * dtf) for c in _RK_C]
            return rk4step.rk4_step_lean(u, v, dtf, gs, lay, md.c0, tables, st,
                                         src_x, abc_x, out=out, scratch=scratch)

        return (*self._steps("step", 3, nsteps, dtf, step, t0, u0, v0), nsteps)

    def solve_lf_n(self, t0, dt, nsteps, u0=None, v0=None):
        """Leapfrog with one 2p value-halo refresh and one call of the step
        kernel per step (kernel H: two launches a block); dt must satisfy
        the leapfrog CFL. Returns (u, v, nsteps); raises a ValueError where
        the path does not apply."""
        md = self.model
        dtf = float(dt)

        def step(lay, tab, u, v, t, out, scratch):
            tables, st, src_x, abc_x = tab
            return lfstep.lf_step(u, v, dtf, md.g_amplitude(t), md.g_amplitude(t + dtf),
                                  lay, md.c0, tables, st, src_x, abc_x, out=out,
                                  scratch=None if scratch is None else scratch[0])

        return (*self._steps("lf", 1, nsteps, dtf, step, t0, u0, v0), nsteps)

    def solve_lf2_n(self, t0, dt, nsteps, u0=None, v0=None):
        """Leapfrog with one 3p value-halo refresh and one call of the 2-step
        kernel per two steps (kernel I: three launches a block); ``nsteps``
        must be even. Returns (u, v, nsteps); raises a ValueError where the
        path does not apply."""
        if nsteps % 2:
            raise ValueError("nsteps must be even for solve_lf2_n (an odd tail "
                             "would need the 2p single-step layout)")
        md = self.model
        dtf = float(dt)

        def step(lay, tab, u, v, t, out, scratch):
            tables, st, src_x, abc_x = tab
            return lf2step.lf2_step(u, v, dtf, md.g_amplitude(t), md.g_amplitude(t + dtf),
                                    md.g_amplitude(t + 2 * dtf), lay, md.c0, tables,
                                    st, src_x, abc_x, out=out, scratch=scratch)

        return (*self._steps("lf2", 3, nsteps // 2, 2 * dtf, step, t0, u0, v0), nsteps)

    def zero_state_step2(self):
        lay = self.halo_layout("step2")
        return self.zero_blocks(lay), self.zero_blocks(lay)

    def solve_step2_n(self, t0, dt, nsteps, u0=None, v0=None):
        """RK4 with one 6p value-halo refresh and one call of the 2-step
        kernel per two steps (kernel J: seven launches a block, the source
        sampled at t + j dt/2, j = 0..4); ``nsteps`` must be even. Returns
        (u, v, nsteps); raises a ValueError where the path does not
        apply."""
        why = self.step2_unavailable
        if why is not None:
            raise ValueError("distributed 2-step RK4 path unavailable for this "
                             f"configuration ({why})")
        if nsteps % 2:
            raise ValueError("nsteps must be even for solve_step2_n (an odd tail "
                             "would need the 3p single-step layout)")
        md = self.model
        dtf = float(dt)

        def step(lay, tab, u, v, t, out, scratch):
            (w1, w2), st, src_x, abc_x = tab
            gs = [md.g_amplitude(t + j * 0.5 * dtf) for j in range(5)]
            return rk42step.rk42_step(u, v, dtf, gs, lay, md.c0, st, w1, w2, src_x,
                                      abc_x, out=out, scratch=scratch)

        return (*self._steps("step2", 6, nsteps // 2, 2 * dtf, step, t0, u0, v0),
                nsteps)

    # -- host conversion ---------------------------------------------------
    def to_global(self, blocked: Blocks, lay: PaddedLayout | None = None) -> np.ndarray:
        """Padded blocks -> the global dof grid (NumPy)."""
        lay = lay or self.layout
        arrs = self.exchange.gather(blocked)
        mx, my, mz = self.parts
        nx, ny, nz = lay.shape
        out = np.empty((mx * (nx - 1) + 1, my * (ny - 1) + 1, mz * (nz - 1) + 1),
                       dtype=arrs[0].dtype)
        for b, a in enumerate(arrs):
            bx, by, bz = self.mesh.coords(b)
            out[bx * (nx - 1) : bx * (nx - 1) + nx,
                by * (ny - 1) : by * (ny - 1) + ny,
                bz * (nz - 1) : bz * (nz - 1) + nz] = a[lay.interior]
        return out

    def to_global_step(self, blocked: Blocks) -> np.ndarray:
        return self.to_global(blocked, self.halo_layout("step"))

    def to_global_lf(self, blocked: Blocks) -> np.ndarray:
        return self.to_global(blocked, self.halo_layout("lf"))

    def to_global_lf2(self, blocked: Blocks) -> np.ndarray:
        return self.to_global(blocked, self.halo_layout("lf2"))

    def to_global_step2(self, blocked: Blocks) -> np.ndarray:
        return self.to_global(blocked, self.halo_layout("step2"))

    def from_global(self, grid: np.ndarray, lay: PaddedLayout | None = None) -> Blocks:
        """The global dof grid -> padded blocks in ``lay`` (default the
        per-stage layout), zero outside each block's interior."""
        lay = lay or self.layout
        nx, ny, nz = lay.shape

        def build(b, c, dev):
            bx, by, bz = c
            blk = np.zeros(lay.padded_shape)
            blk[lay.interior] = grid[bx * (nx - 1) : bx * (nx - 1) + nx,
                                     by * (ny - 1) : by * (ny - 1) + ny,
                                     bz * (nz - 1) : bz * (nz - 1) + nz]
            return self._tensor(blk, dev)

        return self._per_block(build)
