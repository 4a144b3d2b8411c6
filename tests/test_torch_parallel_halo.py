"""The port's value-halo paths (``ShardedPaddedWave.solve_step_n`` on kernel
A's plain version, ``solve_lf_n`` on H's, ``solve_lf2_n`` on I's) against
the JAX package's, on the CPU in float64: the layouts and the per-block
tables exactly, blocked states element for element at 1e-12 (the plain
versions compute what the TPU kernels compute, halo included), the global
grid against the JAX package's single-device solve; one kernel call of
each plain version on a value-halo layout against the JAX kernel in
interpret mode; the guards where the JAX package falls back; the
duplicated plane bitwise equal after a refresh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_cases import jax_model, max_rel, torch_model

from wave_fenics_tpu.core.mesh import FacetTags as JFacetTags
from wave_fenics_tpu.core.mesh import box_mesh as jbox_mesh
from wave_fenics_tpu.models.linear_wave import LinearWave as JLinearWave
from wave_fenics_tpu.models.linear_wave_padded import PaddedLinearWave as JPadded
from wave_fenics_tpu.ops import pallas_lf2step as jlf2
from wave_fenics_tpu.ops import pallas_lfstep as jlf
from wave_fenics_tpu.ops import pallas_rk4step as jstep
from wave_fenics_tpu.parallel.sharded_padded import ShardedPaddedWave as JSharded
from wave_fenics_tpu_torch.convert import blocked_from_numpy, blocked_to_numpy
from wave_fenics_tpu_torch.core.mesh import FacetTags, box_mesh
from wave_fenics_tpu_torch.models.linear_wave import LinearWave
from wave_fenics_tpu_torch.ops import lf2step, lfstep, rk4step
from wave_fenics_tpu_torch.parallel.sharded_padded import ShardedPaddedWave

F64 = torch.float64
TOL = 1e-12
DT = 1e-9
GS = (1.0, 0.7, 0.4, 0.1)


def _pair(shape, parts, p=4, tile_x=16):
    return (JSharded(jax_model(shape, p), parts, tile_x=tile_x),
            ShardedPaddedWave(torch_model(shape, p), parts, tile_x=tile_x))


# path -> (solver, to_global, the JAX model's tables attribute)
PATHS = {
    "step": ("solve_step_n", "to_global_step", "_step_tables"),
    "lf": ("solve_lf_n", "to_global_lf", "_lf_tables"),
    "lf2": ("solve_lf2_n", "to_global_lf2", "_lf2_tables"),
}
CASES = [(path, shape, parts) for path in PATHS
         for shape, parts in (((4, 2, 2), (2, 1, 1)), ((4, 2, 2), (2, 2, 1)),
                              ((6, 2, 2), (3, 2, 1)))]


def _jax_block_tables(jtables, coords):
    tables, deps = jtables
    return [np.asarray(t)[tuple(coords[a] for a in deps[i])]
            for i, t in enumerate(tables)]


@pytest.mark.parametrize("path,shape,parts", CASES)
def test_value_halo_solve_matches_jax(path, shape, parts):
    """Blocked states element for element against the JAX package's
    ShardedPaddedWave (8 steps from a random state), the layouts and tables
    exactly, and the global grid against its single-device solve."""
    solve, to_global, jtab = PATHS[path]
    js, ts = _pair(shape, parts)
    lay = ts.halo_layout(path)
    jlay = getattr(js, "_" + path + "_layout")
    assert (lay.shape, lay.p, lay.tile_x, lay.z_align, lay.halo) == (
        jlay.shape, jlay.p, jlay.tile_x, jlay.z_align, jlay.halo)
    jt = getattr(js, jtab)
    for b, (tables, _, src_x, abc_x) in enumerate(ts._halo_tables(path)):
        for mine, theirs in zip(tables, _jax_block_tables(jt, ts.mesh.coords(b))):
            np.testing.assert_array_equal(mine.numpy(), theirs)
    rng = np.random.default_rng(11)
    gshape = tuple(n * 4 + 1 for n in shape)
    g = [rng.standard_normal(gshape), 1e3 * rng.standard_normal(gshape)]
    ju, jv, _ = getattr(js, solve)(0.0, DT, 8, js.from_global(g[0], jlay),
                                   js.from_global(g[1], jlay))
    tu, tv, n = getattr(ts, solve)(0.0, DT, 8, ts.from_global(g[0], lay),
                                   ts.from_global(g[1], lay))
    assert n == 8
    assert max_rel(blocked_to_numpy(tu, parts), np.asarray(ju)) <= TOL
    assert max_rel(blocked_to_numpy(tv, parts), np.asarray(jv)) <= TOL
    jp = JPadded(js.model, tile_x=16)
    ref = jp.solve_step_n if path == "step" else jp.solve_lf_n
    ur, vr = ref(0.0, DT, 8, jp.from_grid(jnp.asarray(g[0])),
                 jp.from_grid(jnp.asarray(g[1])))[:2]
    assert max_rel(getattr(ts, to_global)(tu), np.asarray(jp.to_grid(ur))) <= TOL
    assert max_rel(getattr(ts, to_global)(tv), np.asarray(jp.to_grid(vr))) <= TOL


@pytest.mark.parametrize("path", ["step", "lf"])
def test_value_halo_zero_start_matches_jax_single_device(path):
    """From the zero state, the source alone drives the run: the step path
    against the JAX package's LinearWave.solve (RK4), the leapfrog against
    its single-device leapfrog step kernel."""
    shape, parts = (4, 2, 2), (2, 2, 1)
    js, ts = _pair(shape, parts)
    solve, to_global, _ = PATHS[path]
    tu, tv, _ = getattr(ts, solve)(0.0, DT, 10)
    if path == "step":
        ur, vr, _ = js.model.solve(0.0, 10 * DT, DT)
    else:
        jp = JPadded(js.model, tile_x=16)
        ur, vr, _ = jp.solve_lf_n(0.0, DT, 10)
        ur, vr = jp.to_grid(ur), jp.to_grid(vr)
    assert max_rel(getattr(ts, to_global)(tv), np.asarray(vr)) <= TOL
    assert max_rel(getattr(ts, to_global)(tu), np.asarray(ur)) <= TOL


@pytest.mark.parametrize("path", ["step", "lf", "lf2"])
def test_plain_kernels_on_halo_layouts_match_jax_kernels(path):
    """One call of kernel A's, H's and I's plain version on each block of a
    (2,2,1) split, from a random state with its value halo refreshed,
    against the JAX kernel (interpret mode) on the same block's tables:
    every padded point, halo included."""
    js, ts = _pair((4, 2, 2), (2, 2, 1))
    lay = ts.halo_layout(path)
    jlay = getattr(js, "_" + path + "_layout")
    c0 = ts.model.c0
    rng = np.random.default_rng(12)
    gshape = tuple(n * 4 + 1 for n in ts.model.mesh.shape)
    u = ts.refresh(ts.from_global(rng.standard_normal(gshape), lay), lay)
    v = ts.refresh(ts.from_global(1e3 * rng.standard_normal(gshape), lay), lay)
    jt = getattr(js, PATHS[path][2])
    if path == "step":
        raw = jstep.make_rk4_step_raw(jlay, c0, dtype=jnp.float64)
        args = (DT, *GS)
    elif path == "lf":
        raw = jlf.make_lf_step_raw(jlay, c0, dtype=jnp.float64)
        args = (DT, *GS[:2])
    else:
        raw = jlf2.make_lf2_step_raw(jlay, c0, dtype=jnp.float64)
        args = (DT, *GS[:3])
    raw = jax.jit(raw)
    for b, (tables, _, _, _) in enumerate(ts._halo_tables(path)):
        jtb = [jnp.asarray(t) for t in _jax_block_tables(jt, ts.mesh.coords(b))]
        ju, jv = raw(jnp.asarray(u[b].numpy()), jnp.asarray(v[b].numpy()), *args, *jtb)
        if path == "step":
            tu, tv = rk4step.rk4_step_lean_plain(u[b], v[b], DT, GS, lay, c0, tables)
        elif path == "lf":
            tu, tv = lfstep.lf_step_plain(u[b], v[b], DT, *GS[:2], lay, c0, tables)
        else:
            tu, tv = lf2step.lf2_step_plain(u[b], v[b], DT, *GS[:3], lay, c0, tables)
        assert max_rel(tu, np.asarray(ju)) <= TOL
        assert max_rel(tv, np.asarray(jv)) <= TOL


def test_refresh_fills_halos_and_canonicalises_the_interface():
    """A refresh of a state whose blocks disagree on a shared plane: every
    halo point the neighbours hold gets their value (x, then y, so the
    corners through two hops), and the shared plane the lower block's."""
    ts = ShardedPaddedWave(torch_model((4, 2, 2), 2), (2, 2, 1), tile_x=16)
    lay = ts.halo_layout("step")
    gshape = tuple(n * 2 + 1 for n in ts.model.mesh.shape)
    g = np.random.default_rng(13).standard_normal(gshape)
    u = ts.from_global(g, lay)
    hi = ts.mesh.index(1, 0, 0)
    u[hi][lay.interior][0] += 1.0  # the upper copy of the x-interface plane
    ts.refresh(u, lay)
    h, (nx, ny, nz) = lay.h, lay.shape
    # block (1, 1, 0) starts at global (nx - 1, ny - 1, 0): its low x and y
    # halos (and their corner) hold the global grid as deep as it reaches
    b = u[ts.mesh.index(1, 1, 0)]
    x0, o = lay.x0, lay.h
    dx, dy = min(h, nx - 1), min(h, ny - 1)
    np.testing.assert_array_equal(
        b[x0 - dx : x0 + nx, o - dy : o + ny, o : o + nz].numpy(),
        g[nx - 1 - dx : 2 * nx - 1, ny - 1 - dy : 2 * ny - 1, :])
    np.testing.assert_array_equal(u[hi][lay.interior][0].numpy(),
                                  u[ts.mesh.index(0, 0, 0)][lay.interior][-1].numpy())


@pytest.mark.parametrize("parts,cells", [((3, 1, 1), (3, 1, 1)), ((4, 2, 1), (8, 2, 1))])
def test_swap_into_reads_every_slab_before_it_is_overwritten(parts, cells):
    """LocalExchange.swap_into, which copies each slab straight into the
    neighbour's view, against swap (every slab taken first) on random
    blocks thinner than their halo, where a block's upward slab reaches
    into the rows its own downward-received view covers."""
    from wave_fenics_tpu_torch.parallel.halo import LocalExchange, refresh_value_halos
    from wave_fenics_tpu_torch.parallel.partition import Blocks, make_device_mesh

    class Snapshot(LocalExchange):
        def swap_into(self, axis, to_left, to_right, into_left, into_right):
            from_left, from_right = self.swap(axis, to_left, to_right)
            for b in self.local_blocks:
                if from_left[b] is not None:
                    into_left[b].copy_(from_left[b])
                if from_right[b] is not None:
                    into_right[b].copy_(from_right[b])

    mesh = make_device_mesh(parts, device="cpu")
    p, h = 2, 6
    ext = tuple(n // m * p + 1 for n, m in zip(cells, parts))
    rng = np.random.default_rng(17)
    blocks = [torch.as_tensor(rng.standard_normal(tuple(e + 2 * h for e in ext)))
              for _ in range(mesh.nblocks)]
    a = refresh_value_halos(Blocks(x.clone() for x in blocks), LocalExchange(mesh),
                            (h, h, h), ext, h)
    b = refresh_value_halos(Blocks(x.clone() for x in blocks), Snapshot(mesh),
                            (h, h, h), ext, h)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_step_duplicated_plane_bitwise_after_refresh():
    ts = ShardedPaddedWave(torch_model((4, 2, 2), 4), (2, 2, 1), tile_x=16)
    lay = ts.halo_layout("step")
    u, v, _ = ts.solve_step_n(0.0, DT, 8)
    ts.refresh(v, lay)
    for by in range(2):
        lo = v[ts.mesh.index(0, by, 0)][lay.interior][-1]
        hi = v[ts.mesh.index(1, by, 0)][lay.interior][0]
        assert torch.equal(lo, hi)
    assert float(v[0][lay.interior][-1].abs().max()) > 0.0


def _jax_box(shape, tags):
    mesh = jbox_mesh(shape, (0.02, 0.01, 0.01), facet_tags=JFacetTags(tags))
    return JLinearWave(mesh, p=4, dtype=jnp.float64)


def _torch_box(shape, tags):
    mesh = box_mesh(shape, (0.02, 0.01, 0.01), facet_tags=FacetTags(tags))
    return LinearWave(mesh, p=4, dtype=F64, device="cpu")


# where the JAX package falls back or raises: one cell a block on an axis
# split four ways (the one-hop guard), the 3D-slab layout, tags off the
# x faces (tests/test_parallel.py:268-320)
GUARDS = [((4, 2, 2), (4, 1, 1), {1: (0,), 2: (1,)}, "flat", "one-hop"),
          ((4, 2, 2), (2, 1, 1), {1: (0,), 2: (1,)}, "3d", "flat layout"),
          ((4, 2, 2), (2, 1, 1), {1: (2,), 2: (1,)}, "flat", "x-low"),
          ((4, 2, 2), (2, 1, 1), {1: (0,), 2: (1, 3)}, "flat", "x-low")]


@pytest.mark.parametrize("shape,parts,tags,kernel,match", GUARDS)
def test_guards_raise_where_jax_falls_back(shape, parts, tags, kernel, match):
    js = JSharded(_jax_box(shape, tags), parts, tile_x=16, kernel=kernel)
    ts = ShardedPaddedWave(_torch_box(shape, tags), parts, tile_x=16, kernel=kernel)
    assert js._step_tables is None and js._lf_tables is None and js._lf2_tables is None
    for name in ("step_unavailable", "lf_unavailable", "lf2_unavailable"):
        assert match in getattr(ts, name)
    for solve in (ts.solve_step_n, ts.solve_lf_n, ts.solve_lf2_n):
        with pytest.raises(ValueError, match=match):
            solve(0.0, DT, 2)
    # the per-stage path the JAX package falls back to still runs
    ts.solve_n(0.0, DT, 1)


def test_step2_and_odd_lf2_raise():
    ts = ShardedPaddedWave(torch_model((4, 2, 2), 4), (2, 1, 1), tile_x=16)
    with pytest.raises(ValueError, match="even"):
        ts.solve_step2_n(0.0, DT, 3)
    with pytest.raises(ValueError, match="even"):
        ts.solve_lf2_n(0.0, DT, 3)
    u, v = ts.zero_state()
    with pytest.raises(ValueError, match="layout"):
        ts.solve_step_n(0.0, DT, 1, u, v)


def test_solve_does_not_write_the_callers_state():
    ts = ShardedPaddedWave(torch_model((4, 2, 2), 4), (2, 2, 1), tile_x=16)
    lay = ts.halo_layout("lf")
    g = np.random.default_rng(14).standard_normal(tuple(n * 4 + 1 for n in (4, 2, 2)))
    u0 = ts.from_global(g, lay)
    before = blocked_to_numpy(u0, (2, 2, 1)).copy()
    ts.solve_lf_n(0.0, DT, 2, u0, blocked_from_numpy(before * 0, "cpu", F64))
    np.testing.assert_array_equal(blocked_to_numpy(u0, (2, 2, 1)), before)
