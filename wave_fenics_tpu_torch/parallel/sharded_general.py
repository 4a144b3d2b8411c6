"""Distributed execution for imported (explicit-dofmap) meshes.

Port of ``wave_fenics_tpu.parallel.sharded_general``. The reference
distributes partitioned DOLFINx meshes with MPI neighbour exchanges over
owned and ghost index maps (demo/gpu_scatter_mpi/VectorUpdater.hpp:21-230,
DOLFINx common::IndexMap); here, as in the JAX package:

- the cells are split by recursive coordinate bisection of their
  centroids (:func:`rcb_partition`);
- each part holds its cells' dofs (owned and interface copies) in a local
  vector, numbered by sorted global id, and a local dofmap over them;
- after a local matrix-free apply (kernel K on a card, its plain version
  on the CPU: ``ops.general``, on the part's own dofmap, colouring and
  geometry) the interface dofs hold partial sums; one of two assembly
  modes completes them, in a fixed order:

  * ``allgather``: one all-gather of each part's interface buffer, then
    each copy adds the other copies' partials in holder order;
  * ``ppermute``: the VectorUpdater's neighbour exchange
    (VectorUpdater.hpp:106-152): a bucket of shared dofs for each pair of
    parts that shares any, the pairs greedily edge-coloured into rounds of
    disjoint pairs, one round of pairwise swaps a colour. Every bucket is
    packed from the partial values before the first round adds anything,
    so a dof held by three or more parts never sends what it received;

  ``exchange="auto"`` picks the smaller traffic a part, as the JAX package
  does;
- ownership weights (1/multiplicity) make the global dots exact.

The collectives are ``halo.Exchange``'s ``all_gather`` and ``swap_pairs``:
``halo.LocalExchange`` for every part in this process (on one card all
parts sit on it), ``distributed.ProcessGroupExchange`` across processes.
Each part is a tensor of its own length (a :class:`partition.Blocks` of
the parts), so the JAX package's padding to fleet maxima, its dummy slot
and its fused-kernel tables, spill path and 128-row padding (TPU layouts)
have no counterpart. No add meets another in one place (the K colours,
distinct interface indices a part and round), so two solves agree bit for
bit.

A bf16 model runs every path on kernel K's bf16 form: the parts' tables
are the model's bf16 tables, -c0^2 stays float32 (the JAX package rounds
c0 to bf16 in its ``_stiffness_local``, 1500 -> 1504, a wave speed 0.24 %
fast), c0^2 g(t) is rounded to bf16 (``WavePhysics._g``), the
assembly adds bf16 partials with one rounding per add (as the JAX
package's), and the ownership weights and the dots are float32.

The host set-up builds the JAX package's tables (``_setup``,
``_nbr_setup``, with its sentinels where a table keeps them) by sorting
and searching, not by the JAX package's dictionaries, so it takes seconds
at millions of dofs.
"""

from __future__ import annotations

from functools import cached_property
from itertools import combinations

import numpy as np
import torch

from ..convert import acc_dtype, tables_from_numpy, widen
from ..models.general_wave import GeneralLinearWave
from ..ops.gather_scatter import colour_cells
from ..ops.general import GeneralTables, general_apply
from ..solvers.cg import cg
from ..solvers.leapfrog import leapfrog_solve_n
from ..solvers.rk4 import rk4_solve_n
from .halo import Exchange, LocalExchange
from .partition import Blocks, per_block
from .sharded_wave import block_mesh

__all__ = ["EXCHANGES", "rcb_partition", "ShardedGeneralWave"]

#: the assembly modes: ``auto`` resolves to one of the other two
EXCHANGES = ("auto", "allgather", "ppermute")


def rcb_partition(points: np.ndarray, nparts: int) -> np.ndarray:
    """Recursive coordinate bisection of a point set into ``nparts``
    balanced parts (the mesh-agnostic analogue of the reference's Cartesian
    decompose, demo/gpu_cg/mesh.hpp:37-112): the part id of each point. A
    copy of the JAX package's (NumPy), ties and odd counts split alike."""
    parts = np.zeros(len(points), np.int32)

    def rec(idx, lo, n):
        if n == 1:
            parts[idx] = lo
            return
        n0 = n // 2
        axis = int(np.argmax(np.ptp(points[idx], axis=0)))
        order = idx[np.argsort(points[idx][:, axis], kind="stable")]
        cut = len(idx) * n0 // n
        rec(order[:cut], lo, n0)
        rec(order[cut:], lo + n0, n - n0)

    rec(np.arange(len(points)), 0, nparts)
    return parts


class ShardedGeneralWave:
    """``GeneralLinearWave`` distributed over ``ndev`` parts of its cells.
    ``devices``/``device`` place the parts (``partition.make_device_mesh``
    on (ndev, 1, 1); by default the model's device type: every visible card
    in turn, or the CPU), ``exchange`` is the assembly mode (one of
    :data:`EXCHANGES`) and ``comm`` the ``halo.Exchange`` that moves the
    buffers (default ``halo.LocalExchange``: every part in this process).
    States are Blocks of per-part vectors (:meth:`zero_state`,
    :meth:`from_global`)."""

    def __init__(self, model: GeneralLinearWave, ndev: int, devices=None, device=None,
                 exchange: str = "auto", comm: Exchange | None = None):
        if exchange not in EXCHANGES:
            raise ValueError(f"unknown exchange mode {exchange!r}: one of {EXCHANGES}")
        if ndev < 1:
            raise ValueError(f"ndev = {ndev}: at least 1")
        self.model = model
        self.ndev = int(ndev)
        self.exchange = exchange
        self.mesh = block_mesh(model, (self.ndev, 1, 1), devices, device, comm)
        self.comm = comm if comm is not None else LocalExchange(self.mesh)

    # -- host set-up: partition, local maps, exchange tables ----------------
    @cached_property
    def _setup(self) -> dict:
        """The JAX package's ``_setup`` tables, per part unpadded: ``part``,
        ``cells_of``, ``loc_ids`` (sorted global ids), ``ldof`` (local
        dofmaps), ``counts`` (holders of each global dof), ``bidx`` (the
        local index of each interface slot), ``recv`` ([S_i, K]: the flat
        index j * S + slot of each other copy in the all-gathered buffers,
        in holder order, ndev * S where a dof has fewer copies), ``S`` (the
        most slots a part) and ``K``; plus the holders of each interface
        dof for :attr:`_nbr_setup`."""
        md, n = self.model, self.ndev
        dofmap = np.asarray(md.dofs.dofmap, np.int64)
        part = rcb_partition(md.mesh.cell_coords().mean(axis=1), n)
        cells_of = [np.flatnonzero(part == i) for i in range(n)]
        loc_ids = [np.unique(dofmap[c]) for c in cells_of]
        ldof = [np.searchsorted(ids, dofmap[c]).astype(np.int32)
                for ids, c in zip(loc_ids, cells_of)]
        counts = np.zeros(md.ndofs, np.int32)
        for ids in loc_ids:
            counts[ids] += 1
        shared = counts > 1
        bidx = [np.flatnonzero(shared[ids]).astype(np.int32) for ids in loc_ids]
        S = max((len(b) for b in bidx), default=1) or 1
        deg = max((int(counts[ids[b]].max()) for ids, b in zip(loc_ids, bidx) if len(b)),
                  default=2)
        K = max(deg - 1, 1)
        # every interface copy (part, slot, global id), grouped by global id
        # with the holders in part order
        P = np.concatenate([np.full(len(b), i) for i, b in enumerate(bidx)])
        slot = np.concatenate([np.arange(len(b)) for b in bidx])
        gid = np.concatenate([ids[b] for ids, b in zip(loc_ids, bidx)])
        order = np.lexsort((P, gid))
        P, slot, gid = P[order], slot[order], gid[order]
        first = np.ones(len(gid), bool)
        first[1:] = gid[1:] != gid[:-1]
        grp = np.cumsum(first) - 1
        rank = np.arange(len(gid)) - np.flatnonzero(first)[grp]
        mult = counts[gid]
        holders = np.full((int(first.sum()), deg), -1, np.int64)
        hslot = np.zeros_like(holders)
        holders[grp, rank] = P
        hslot[grp, rank] = slot
        # the k-th other copy of each copy: holder rank k, or k + 1 past its own
        k = np.arange(K)[None, :]
        kk = k + (k >= rank[:, None])
        kc = np.minimum(kk, deg - 1)
        vals = np.where(kk < mult[:, None],
                        holders[grp[:, None], kc] * S + hslot[grp[:, None], kc], n * S)
        recv = [np.empty((len(b), K), np.int32) for b in bidx]
        for i in range(n):
            sel = P == i
            recv[i][slot[sel]] = vals[sel]
        return dict(part=part, cells_of=cells_of, loc_ids=loc_ids, ldof=ldof,
                    counts=counts, bidx=bidx, recv=recv, S=S, K=K,
                    holders=holders, holder_gids=gid[first])

    @cached_property
    def _nbr_setup(self) -> dict | None:
        """The pairwise exchange tables (``ppermute``), the JAX package's
        ``_nbr_setup``: for each pair of parts sharing interface dofs, a
        bucket of their common dofs sorted by global id; the pairs, largest
        bucket first (ties in the order the JAX package's dictionary meets
        them), greedily edge-coloured into ``NR`` rounds of disjoint pairs.
        ``perms[r]`` lists both directions of each pair of round r,
        ``sidx[i][r]`` the local indices of part i's bucket in round r (None
        where it sits out; what it receives adds at the same indices, the
        JAX package's ``ridx``), ``Sb`` the largest bucket. None where no
        dof is shared (ndev = 1)."""
        s = self._setup
        hold, gids = s["holders"], s["holder_gids"]
        if len(gids) == 0:
            return None
        n = self.ndev
        mult = (hold >= 0).sum(axis=1)
        # the JAX package meets the dofs in the order of their lowest
        # holder, then global id, and each dof's holder pairs in order
        gpos = np.empty(len(gids), np.int64)
        gpos[np.lexsort((gids, hold[:, 0]))] = np.arange(len(gids))
        combos = {c: list(combinations(range(c), 2)) for c in np.unique(mult).tolist()}
        E = max(len(v) for v in combos.values())
        pa, pb, pg, seen = [], [], [], []
        for c, cs in combos.items():
            rows = np.flatnonzero(mult == c)
            for e, (a, b) in enumerate(cs):
                pa.append(hold[rows, a])
                pb.append(hold[rows, b])
                pg.append(gids[rows])
                seen.append(gpos[rows] * E + e)
        pa, pb, pg, seen = (np.concatenate(x) for x in (pa, pb, pg, seen))
        key = pa * n + pb
        keys, inv, sizes = np.unique(key, return_inverse=True, return_counts=True)
        met = np.full(len(keys), np.iinfo(np.int64).max)
        np.minimum.at(met, inv, seen)
        by_meeting = np.argsort(met, kind="stable")
        order = by_meeting[np.argsort(-sizes[by_meeting], kind="stable")]
        colours: list[list[int]] = []
        used: list[set[int]] = []
        for q in order.tolist():
            i, j = divmod(int(keys[q]), n)
            for r, u in enumerate(used):
                if i not in u and j not in u:
                    colours[r].append(q)
                    u.update((i, j))
                    break
            else:
                colours.append([q])
                used.append({i, j})
        # each pair's dofs sorted by global id
        srt = np.lexsort((pg, inv))
        bounds = np.concatenate([[0], np.cumsum(sizes)])
        loc_ids = s["loc_ids"]
        sidx = [[None] * len(colours) for _ in range(n)]
        perms = []
        for r, cls in enumerate(colours):
            pr = []
            for q in cls:
                i, j = divmod(int(keys[q]), n)
                gs = pg[srt[bounds[q]:bounds[q + 1]]]
                sidx[i][r] = np.searchsorted(loc_ids[i], gs).astype(np.int32)
                sidx[j][r] = np.searchsorted(loc_ids[j], gs).astype(np.int32)
                pr += [(i, j), (j, i)]
            perms.append(tuple(pr))
        return dict(NR=len(colours), Sb=int(sizes.max()), perms=tuple(perms), sidx=sidx)

    @cached_property
    def exchange_mode(self) -> str:
        """The assembly mode that runs ("allgather" or "ppermute"): ``auto``
        takes ppermute where its traffic a part, NR rounds of Sb-slot
        buckets, is below the all-gather's ndev x S."""
        if self.exchange != "auto":
            return self.exchange
        ns = self._nbr_setup
        if ns is None:
            return "allgather"
        return ("ppermute" if ns["NR"] * ns["Sb"] < self.ndev * self._setup["S"]
                else "allgather")

    def prepare(self) -> "ShardedGeneralWave":
        """Build the host set-up and the parts' tables now (otherwise the
        first solve or assembly builds them); returns self."""
        self._tables
        return self

    # -- device tables -------------------------------------------------------
    @property
    def _own(self) -> list[int]:
        return self.comm.local_blocks

    def _local(self, x, dtype=None) -> Blocks:
        """The per-part slices of a global vector (NumPy or a tensor), in
        ``dtype`` (default the model's) on each held part's device."""
        ids, dtype = self._setup["loc_ids"], dtype or self.model.dtype
        if isinstance(x, torch.Tensor):
            def take(i, c, dev):
                return x[torch.as_tensor(ids[i], device=x.device)].to(device=dev,
                                                                      dtype=dtype)
        else:
            x = np.asarray(x)

            def take(i, c, dev):
                return torch.as_tensor(x[ids[i]], device=dev).to(dtype)

        return per_block(self.mesh, self._own, take)

    @cached_property
    def _tables(self) -> dict:
        """Each held part's tables on its device: kernel K's
        (``ops.general.GeneralTables`` of the model's stiffness mode on the
        local dofmap, its colouring and the model's geometry sliced to the
        part's cells), the per-dof vectors m, 1/m, W1, W2 and the ownership
        weights, and the assembly's indices."""
        md, s = self.model, self._setup
        mode = md.ops.mode("stiffness")
        geo = md.ops.geometry_tables(mode, md.device)
        B, D = tables_from_numpy((md.ops._B, md.ops._D), "cpu", md.dtype)
        out = {name: self._local(getattr(md, name))
               for name in ("m", "inv_m", "W1", "W2")}
        out["own"] = self._local(1.0 / s["counts"].astype(np.float64), acc_dtype(md.dtype))
        out["K"] = {}
        out["bidx"], out["recv"], out["send"], out["sidx"] = {}, {}, {}, {}
        S1 = s["S"] + 1
        ns = self._nbr_setup
        for i in self._own:
            dev = self.mesh.devices[i]
            cells = s["cells_of"][i]
            cs, starts = colour_cells(s["ldof"][i], md.p + 1)
            ci = torch.as_tensor(cells, device=geo[0].device)
            out["K"][i] = GeneralTables(
                mode, torch.as_tensor(s["ldof"][i], device=dev),
                torch.as_tensor(cs, device=dev), torch.as_tensor(starts),
                len(s["loc_ids"][i]), B.to(dev), D.to(dev),
                geo[0][:, ci].to(dev).contiguous(),
                geo[1].to(dev) if len(geo) > 1 else None)
            out["bidx"][i] = torch.as_tensor(s["bidx"][i], dtype=torch.int64, device=dev)
            # the all-gathered buffers have S + 1 slots a part, the last
            # always 0: recv's index j * S + slot becomes j * (S + 1) + slot,
            # and its "no copy" index ndev * S part 0's zero slot S
            r = s["recv"][i].astype(np.int64)
            r = np.where(r == self.ndev * s["S"], s["S"], r // s["S"] * S1 + r % s["S"])
            out["recv"][i] = torch.as_tensor(r, device=dev)
            out["send"][i] = torch.zeros(S1, dtype=md.dtype, device=dev)
            if ns is not None:
                out["sidx"][i] = [None if x is None else
                                  torch.as_tensor(x, dtype=torch.int64, device=dev)
                                  for x in ns["sidx"][i]]
        return out

    # -- local physics ---------------------------------------------------------
    def _assemble(self, b: Blocks) -> Blocks:
        """Sum the interface partials across parts, in place
        (VectorUpdater.hpp:106-152 semantics, in a fixed order): one
        all-gather and the other copies' sum, or the pairwise rounds.
        Returns ``b``."""
        tb, own = self._tables, self._own
        if self.exchange_mode == "ppermute":
            ns = self._nbr_setup
            if ns is None:
                return b
            # every round's bucket packed before the first add: the partials
            sends = {}
            for i in own:
                for r, idx in enumerate(tb["sidx"][i]):
                    if idx is not None:
                        sends[(i, r)] = b[i][idx]
            for r, perm in enumerate(ns["perms"]):
                pairs = perm[::2]
                got = self.comm.swap_pairs(pairs, {(a, c): sends[(a, r)] for a, c in perm
                                                   if a in own})
                for (a, _), x in got.items():
                    b[a].index_add_(0, tb["sidx"][a][r], x)
            return b
        bufs = Blocks([None] * self.ndev)
        for i in own:
            buf = tb["send"][i]
            torch.index_select(b[i], 0, tb["bidx"][i], out=buf[: tb["bidx"][i].numel()])
            bufs[i] = buf
        full = self.comm.all_gather(bufs)
        for i in own:
            b[i].index_add_(0, tb["bidx"][i], full[i][tb["recv"][i]].sum(dim=1))
        return b

    def _stiffness(self, u: Blocks) -> Blocks:
        """The assembled -c0^2 K u: kernel K (or its plain version) on each
        part, then :meth:`_assemble`."""
        md, tb = self.model, self._tables
        b = Blocks([None] * self.ndev)
        for i in self._own:
            b[i] = general_apply(u[i], tb["K"][i], md.ops._coeff(u[i], md.c0))
        return self._assemble(b)

    def _source(self, t: float) -> torch.Tensor:
        return self.model._g(t)

    def _f1(self, t, u: Blocks, v: Blocks) -> Blocks:
        """dv/dt, in ``GeneralLinearWave.f1``'s order."""
        md, tb = self.model, self._tables
        b, g = self._stiffness(u), self._source(t)
        for i in self._own:
            b[i] = (b[i] + g * tb["W1"][i] - md.c0 * (tb["W2"][i] * v[i])) * tb["inv_m"][i]
        return b

    def _force(self, t, u: Blocks) -> Blocks:
        """The leapfrog's v-independent acceleration (``force``)."""
        tb = self._tables
        b, g = self._stiffness(u), self._source(t)
        for i in self._own:
            b[i] = (b[i] + g * tb["W1"][i]) * tb["inv_m"][i]
        return b

    @cached_property
    def _damping(self) -> Blocks:
        """The leapfrog's diagonal damping c0 W2 / m on each part."""
        tb = self._tables
        return self.model.c0 * tb["W2"] * tb["inv_m"]

    # -- solves --------------------------------------------------------------
    def zero_state(self) -> tuple[Blocks, Blocks]:
        ids = self._setup["loc_ids"]

        def zeros(i, c, dev):
            return torch.zeros(len(ids[i]), dtype=self.model.dtype, device=dev)

        return per_block(self.mesh, self._own, zeros), per_block(self.mesh, self._own, zeros)

    def solve_n(self, t0: float, dt: float, nsteps: int, u0=None, v0=None,
                integrator: str = "rk4"):
        """``nsteps`` steps of RK4 (4 assembled applies a step) or leapfrog
        (one a step and one at t0; dt up to about 0.71x the RK4 CFL step,
        ``solvers/leapfrog.py``); returns (u, v, nsteps) as Blocks."""
        if integrator not in ("rk4", "leapfrog"):
            raise ValueError(f"unknown integrator: {integrator!r}")
        if u0 is None:
            u0, v0 = self.zero_state()
        u0, v0 = Blocks(u0), Blocks(v0)
        if integrator == "leapfrog":
            u, v = leapfrog_solve_n(self._force, self._damping, u0, v0, t0, dt, nsteps)
        else:
            u, v = rk4_solve_n(lambda t, u, v: v, self._f1, u0, v0, t0, dt, nsteps)
        return u, v, nsteps

    def cg_solve(self, b: Blocks, tau: float, kmax: int = 50, rtol: float = 1e-8):
        """Distributed CG on ``(diag(m) + tau K) x = b``, K the positive
        c0^2-weighted stiffness and m the lumped mass (tau = beta dt^2 of an
        implicit Newmark step): the reference's distributed matrix-free CG
        (demo/gpu_cg/CUDA/cg.hpp:37-121, a VectorUpdater exchange each
        iteration) on an imported mesh. ``b`` holds assembled values on
        each part; Jacobi preconditioning by 1/m, the ownership-weighted
        :meth:`dot`. Returns (x, iterations, |r|^2)."""
        tb = self._tables

        def matvec(x):
            s = self._stiffness(x)
            return tb["m"] * x - tau * s

        x0 = Blocks(None if x is None else torch.zeros_like(x) for x in b)
        return cg(matvec, Blocks(b), x0=x0, kmax=kmax, rtol=rtol,
                  precond=lambda r: r / tb["m"], dot=self.dot)

    # -- global <-> local, weighted reductions ---------------------------------
    def from_global(self, x) -> Blocks:
        """A global vector (NumPy or a tensor) as per-part vectors."""
        return self._local(x)

    def to_global(self, xs: Blocks) -> np.ndarray:
        """Per-part vectors -> the global vector (NumPy; a dof held by
        several parts takes the last part's copy)."""
        arrs = self.comm.gather(xs)
        out = np.zeros(self.model.ndofs, arrs[0].dtype)
        for ids, a in zip(self._setup["loc_ids"], arrs):
            out[ids] = a
        return out

    def dot(self, a: Blocks, b: Blocks) -> torch.Tensor:
        """Ownership-weighted global inner product (each shared dof counted
        once; the MPI_Allreduce of cg.hpp:88-91): a 0-d tensor on the first
        held part's device, in the arithmetic type (float32 for bf16)."""
        own = self._own
        w = self._tables["own"]
        dev = self.mesh.devices[own[0]]
        s = None
        for i in own:
            ai, bi = widen(a[i], b[i])
            x = (ai * bi * w[i]).sum().to(dev)
            s = x if s is None else s + x
        return self.comm.allreduce(s)
