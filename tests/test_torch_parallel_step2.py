"""The port's distributed 2-step RK4 (``ShardedPaddedWave.solve_step2_n``,
kernel J's plain version on the 6p value-halo layout) against the JAX
package's ``solve_step2_n`` and against the port's one-device
``solve_step_n``, on the CPU in float64, from a random O(1) state (a zero
state leaves the deep halo exponentially small, so the comparison would
be vacuous); the raises where the JAX package raises; the rings of J's
seven launches.
"""

import numpy as np
import pytest
import torch
from _torch_cases import jax_model, max_rel, torch_model

from wave_fenics_tpu.parallel.sharded_padded import ShardedPaddedWave as JSharded
from wave_fenics_tpu_torch.models.linear_wave_padded import PaddedLinearWave
from wave_fenics_tpu_torch.ops import rk42step
from wave_fenics_tpu_torch.ops.wave import PaddedLayout
from wave_fenics_tpu_torch.parallel.sharded_padded import ShardedPaddedWave

TOL = 1e-12
DT = 1e-9
P = 4


def _random_state(cells, seed=3):
    rng = np.random.default_rng(seed)
    g = tuple(n * P + 1 for n in cells)
    return rng.standard_normal(g), rng.standard_normal(g)


# JAX's two cases (tests/test_parallel.py:225-279); (15,4,4) on (3,1,1)
# sits on the one-hop guard's edge: 5 cells a block on an axis split 3 ways
@pytest.mark.parametrize("cells,parts", [((8, 4, 4), (2, 2, 2)),
                                         ((15, 4, 4), (3, 1, 1))])
def test_solve_step2_n_matches_jax_and_one_device(cells, parts):
    u0, v0 = _random_state(cells)
    js = JSharded(jax_model(cells, P), parts, tile_x=24)
    jlay = js._rk42_layout
    ju, jv, _ = js.solve_step2_n(0.0, DT, 12, js.from_global(u0, jlay),
                                 js.from_global(v0, jlay))
    ju, jv = js.to_global_rk42(ju), js.to_global_rk42(jv)

    model = torch_model(cells, P)
    ts = ShardedPaddedWave(model, parts, tile_x=24)
    assert ts.step2_unavailable is None
    lay = ts.halo_layout("step2")
    assert (lay.h, lay.tile_x, lay.padded_shape) == (jlay.h, jlay.tile_x,
                                                     jlay.padded_shape)
    with pytest.raises(ValueError, match="even"):
        ts.solve_step2_n(0.0, DT, 11)
    u, v, n = ts.solve_step2_n(0.0, DT, 12, ts.from_global(u0, lay),
                               ts.from_global(v0, lay))
    assert n == 12
    gu, gv = ts.to_global_step2(u), ts.to_global_step2(v)
    assert max_rel(gu, ju) <= TOL and max_rel(gv, jv) <= TOL

    pm = PaddedLinearWave(model, tile_x=24)
    ur, vr, _ = pm.solve_step_n(0.0, DT, 12, pm.from_grid(torch.as_tensor(u0)),
                                pm.from_grid(torch.as_tensor(v0)))
    assert max_rel(gu, pm.to_grid(ur)) <= TOL
    assert max_rel(gv, pm.to_grid(vr)) <= TOL


def test_step2_unavailable_raises_as_jax():
    """< 5 cells a block on an axis split >= 3 ways cannot supply the 6p
    one-hop value halo (tests/test_parallel.py:270-279)."""
    js = JSharded(jax_model((8, 4, 4), P), (4, 1, 2), tile_x=24)
    ts = ShardedPaddedWave(torch_model((8, 4, 4), P), (4, 1, 2), tile_x=24)
    assert js._rk42_tables is None
    assert "5 cells" in ts.step2_unavailable
    for sw in (js, ts):
        with pytest.raises(ValueError, match="2-step RK4"):
            sw.solve_step2_n(0.0, DT, 2)
    # the 3p paths still apply there (2 cells a block)
    assert ts.step_unavailable is None


def test_zero_state_step2_is_the_step2_layout():
    ts = ShardedPaddedWave(torch_model((4, 2, 2), P), (2, 1, 1), tile_x=16)
    u, v = ts.zero_state_step2()
    lay = ts.halo_layout("step2")
    assert lay.h == 6 * P and lay.tile_x >= rk42step._off0(P)
    assert all(tuple(x.shape) == lay.padded_shape for x in (*u, *v))
    u2, v2, _ = ts.solve_step2_n(0.0, DT, 2)
    assert float(np.abs(ts.to_global_step2(v2)).max()) > 0.0  # the source acts


@pytest.mark.parametrize("p", [2, 3, 4, 5])
def test_call_rings(p):
    shape = (2 * p + 1,) * 3
    one = PaddedLayout(shape=shape, p=p, tile_x=rk42step._off0(p), z_align=16)
    assert rk42step.call_rings(one) == ((0,) * 7, 0)
    for h in (4 * p, 6 * p):
        lay = PaddedLayout(shape=shape, p=p, tile_x=rk42step._off0(p), z_align=16,
                           halo=h)
        assert rk42step.call_rings(lay) == ((3 * p, 3 * p, 2 * p, 2 * p, p, 0, 0), p)
    low = PaddedLayout(shape=shape, p=p, tile_x=rk42step._off0(p), z_align=16,
                       halo=4 * p - 1)
    with pytest.raises(ValueError, match="4p"):
        rk42step.call_rings(low)


def test_rk42_step_plain_on_a_value_halo_is_zero_beyond_its_rings():
    """One call on a refreshed 6p layout: u2, v2 on the interior only, and
    the boundary's (u1, v1, kv0') on the interior grown by 2p."""
    ts = ShardedPaddedWave(torch_model((8, 4, 4), P), (2, 1, 1), tile_x=24)
    lay = ts.halo_layout("step2")
    u0, v0 = _random_state((8, 4, 4), seed=9)
    u = ts.refresh(ts.from_global(u0, lay), lay)
    v = ts.refresh(ts.from_global(v0, lay), lay)
    (w1, w2), st, src_x, abc_x = ts._halo_tables("step2")[0]
    # block 0's 6p halo holds the global x-high face 2 x 16 rows on
    assert src_x == lay.x0 and abc_x == lay.x0 + 32
    gs = (1.0, 0.8, 0.55, 0.3, 0.1)
    u2, v2 = rk42step.rk42_step_plain(u[0], v[0], DT, gs, lay, 1500.0, st, w1, w2,
                                      src_x, abc_x)
    kv = [rk42step.apply_stencil_plain(u[0], lay, st, r) for r in (0, 3 * P)]
    for x, ring in ((u2, 0), (v2, 0), (kv[0], 0), (kv[1], 3 * P)):
        x0, nx, h, ny, nz = lay.box(ring)
        outside = x.clone()
        outside[x0 : x0 + nx, h : h + ny, h : h + nz] = 0.0
        assert float(outside.abs().max()) == 0.0
    # the 3p x-halo rows towards block 1 are computed (those below x0 lie
    # outside the domain, where the tables are 0)
    x0, nx, h, ny, nz = lay.box(3 * P)
    assert float(kv[1][x0 + nx - 3 * P : x0 + nx].abs().max()) > 0.0
