"""The port's distributed structured box (``wave_fenics_tpu_torch.parallel``)
against the JAX package's, on the CPU in float64: the partition and the
ownership weights exactly, ``ShardedLinearWave`` (stiffness, solve, dot,
the CG mass solve) and ``ShardedPaddedWave.solve_n`` (kernel B's and E's
plain versions, the per-stage halo-add) at 1e-12, blocked states element
for element. The JAX side runs on ``tests/conftest.py``'s 8 virtual CPU
devices under ``jit``, as ``tests/test_parallel.py`` runs it. The
value-halo paths are in ``test_torch_parallel_halo.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_cases import jax_model, max_rel, torch_model

from wave_fenics_tpu.models.linear_wave_padded import PaddedLinearWave as JPadded
from wave_fenics_tpu.parallel import partition as jpart
from wave_fenics_tpu.parallel.sharded_padded import ShardedPaddedWave as JSharded
from wave_fenics_tpu.parallel.sharded_wave import ShardedLinearWave as JShardedLinear
from wave_fenics_tpu.parallel.sharded_wave import ownership_weights as jownership
from wave_fenics_tpu.solvers.cg import cg as jcg
from wave_fenics_tpu_torch.convert import blocked_from_numpy, blocked_to_numpy
from wave_fenics_tpu_torch.parallel import halo, partition
from wave_fenics_tpu_torch.parallel.sharded_padded import ShardedPaddedWave
from wave_fenics_tpu_torch.parallel.sharded_wave import ShardedLinearWave, ownership_weights

F64 = torch.float64
TOL = 1e-12
DT = 1e-9
NSTEPS = 4


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16, 24, 30, 64, 97])
def test_decompose3d_matches_jax(n):
    assert partition.decompose3d(n) == jpart.decompose3d(n)
    assert partition._prime_factors(n) == jpart._prime_factors(n)


@pytest.mark.parametrize("parts", [(2, 2, 1), (3, 1, 2), (2, 2, 2)])
def test_block_unblock_match_jax(parts):
    g = np.random.default_rng(0).standard_normal((13, 9, 9))  # p=2, cells (6, 4, 4)
    b = partition.block_grid(g, parts, 2)
    np.testing.assert_array_equal(b, jpart.block_grid(g, parts, 2))
    np.testing.assert_array_equal(partition.unblock_grid(b, 2), jpart.unblock_grid(b, 2))
    np.testing.assert_array_equal(partition.unblock_grid(b, 2), g)


@pytest.mark.parametrize("parts,shape", [((2, 2, 2), (5, 5, 5)), ((3, 2, 1), (5, 7, 9))])
def test_ownership_weights_match_jax(parts, shape):
    w = ownership_weights(parts, shape)
    np.testing.assert_array_equal(w, jownership(parts, shape))
    n = [m * (s - 1) + 1 for m, s in zip(parts, shape)]
    assert w.sum() == np.prod(n)


def test_device_mesh_places_blocks():
    m = partition.make_device_mesh((2, 2, 1), device="cpu")
    assert m.devices == (torch.device("cpu"),) * 4
    assert m.coords(m.index(1, 0, 0)) == (1, 0, 0)
    assert m.neighbour(m.index(0, 1, 0), 1, -1) == m.index(0, 0, 0)
    assert m.neighbour(m.index(0, 1, 0), 1, +1) is None
    m = partition.make_device_mesh((3, 1, 1), devices=["cpu", "meta"])
    assert [d.type for d in m.devices] == ["cpu", "meta", "cpu"]
    if not torch.cuda.is_available():
        # no fallback to the CPU: the blocks go there only when asked
        with pytest.raises(ValueError, match="no CUDA card"):
            partition.make_device_mesh((2, 1, 1))


def test_blocked_conversion_roundtrip():
    a = np.random.default_rng(1).standard_normal((2, 3, 1, 4, 5, 6))
    blocks = blocked_from_numpy(a, "cpu", F64)
    assert len(blocks) == 6 and tuple(blocks[3].shape) == (4, 5, 6)
    np.testing.assert_array_equal(blocks[(1 * 3 + 0) * 1 + 0].numpy(), a[1, 0, 0])
    np.testing.assert_array_equal(blocked_to_numpy(blocks, (2, 3, 1)), a)


def test_blocks_arithmetic():
    x = partition.Blocks([torch.ones(2), None, 2 * torch.ones(3)])
    y = 2.0 * x + x * torch.tensor(3.0) - (-x)
    assert y[1] is None and torch.equal(y[2], 12 * torch.ones(3))


def test_halo_sync_restores_invariant():
    """halo_sync (update_fwd) repairs the duplicated planes: the lower
    block's copy wins, as in the JAX package."""
    p, parts = 2, (2, 2, 2)
    g = np.random.default_rng(4).standard_normal((9, 9, 9))
    blocked = partition.block_grid(g, parts, p)
    corrupted = blocked.copy()
    corrupted[1, :, :, 0, :, :] = -999.0
    corrupted[:, 1, :, :, 0, :] = -999.0
    corrupted[:, :, 1, :, :, 0] = -999.0
    blocks = blocked_from_numpy(corrupted, "cpu", F64)
    ex = halo.LocalExchange(partition.make_device_mesh(parts, device="cpu"))
    halo.halo_sync(blocks, ex)
    np.testing.assert_array_equal(blocked_to_numpy(blocks, parts), blocked)


def test_halo_add_sums_both_sides_bitwise():
    """After halo_add both copies of every shared plane hold the same sum,
    bit for bit, and it is the unblocked sum of the per-block parts."""
    parts = (2, 2, 1)
    rng = np.random.default_rng(5)
    a = rng.standard_normal((2, 2, 1, 5, 5, 5))
    blocks = blocked_from_numpy(a, "cpu", F64)
    halo.halo_add(blocks, halo.LocalExchange(partition.make_device_mesh(parts, device="cpu")))
    out = blocked_to_numpy(blocks, parts)
    np.testing.assert_array_equal(out[0, :, :, -1], out[1, :, :, 0])
    np.testing.assert_array_equal(out[:, 0, :, :, -1], out[:, 1, :, :, 0])
    np.testing.assert_allclose(out[0, 0, 0, -1, 1:-1], a[0, 0, 0, -1, 1:-1] + a[1, 0, 0, 0, 1:-1],
                               rtol=1e-15)


# -- ShardedLinearWave (kernel F's plain version per block) -----------------

def _linear_pair(shape=(4, 4, 2), p=3):
    return jax_model(shape, p), torch_model(shape, p)


@pytest.mark.parametrize("parts", [(2, 1, 1), (2, 2, 1), (2, 2, 2), (4, 2, 1)])
def test_sharded_stiffness_matches_jax(parts):
    jm, tm = _linear_pair()
    js, ts = JShardedLinear(jm, parts), ShardedLinearWave(tm, parts)
    g = np.random.default_rng(1).standard_normal(jm.ops.grid_shape)
    jy = np.asarray(js.stiffness(js.from_global(g), 1500.0))
    ty = ts.stiffness(ts.from_global(g), 1500.0)
    assert max_rel(blocked_to_numpy(ty, parts), jy) <= TOL
    y1 = np.asarray(jm.ops.stiffness(jnp.asarray(g), 1500.0))
    assert max_rel(ts.to_global(ty), y1) <= TOL


@pytest.mark.parametrize("parts", [(2, 2, 2), (4, 1, 1)])
def test_sharded_linear_solve_matches_jax(parts):
    jm, tm = _linear_pair(shape=(8, 2, 2))
    js, ts = JShardedLinear(jm, parts), ShardedLinearWave(tm, parts)
    ju, jv, _ = js.solve_n(0.0, 2e-9, 10)
    tu, tv, n = ts.solve_n(0.0, 2e-9, 10)
    assert n == 10
    assert max_rel(blocked_to_numpy(tu, parts), np.asarray(ju)) <= TOL
    assert max_rel(blocked_to_numpy(tv, parts), np.asarray(jv)) <= TOL
    u1, v1, _ = jm.solve(0.0, 10 * 2e-9, 2e-9)
    assert max_rel(ts.to_global(tv), np.asarray(v1)) <= 1e-10


def test_sharded_dot_matches_jax():
    jm, tm = _linear_pair()
    js, ts = JShardedLinear(jm, (2, 2, 2)), ShardedLinearWave(tm, (2, 2, 2))
    rng = np.random.default_rng(2)
    a, b = (rng.standard_normal(jm.ops.grid_shape) for _ in range(2))
    d = float(ts.dot(ts.from_global(a), ts.from_global(b)))
    jd = float(js.dot(js.from_global(a), js.from_global(b)))
    assert abs(d - jd) <= TOL * abs(jd)
    assert abs(d - np.vdot(a, b)) <= TOL * abs(np.vdot(a, b))


def test_distributed_cg_mass_solve_matches_jax():
    """CG on the sharded spectral mass with the weighted dot (the gpu_cg
    workload distributed), against the JAX package's under jit."""
    jm, tm = _linear_pair(shape=(4, 4, 4), p=2)
    js, ts = JShardedLinear(jm, (2, 2, 2)), ShardedLinearWave(tm, (2, 2, 2))
    b = np.random.default_rng(3).standard_normal(jm.ops.grid_shape)
    jx, jk, _ = jax.jit(lambda bb: jcg(js.spectral_mass, bb, kmax=60, rtol=1e-10,
                                       dot=js.dot))(js.from_global(b))
    x, k, _ = ts.cg_mass(ts.from_global(b), kmax=60, rtol=1e-10)
    assert k == int(jk)
    assert max_rel(blocked_to_numpy(x, (2, 2, 2)), np.asarray(jx)) <= TOL
    res = tm.ops.spectral_mass(torch.as_tensor(ts.to_global(x))).numpy() - b
    assert np.linalg.norm(res) / np.linalg.norm(b) < 1e-8


# -- ShardedPaddedWave.solve_n: the per-stage halo-add on B's and E's plain
# versions ----------------------------------------------------------------

SOLVE_N_CASES = [((4, 2, 2), (2, 1, 1), "flat", True), ((4, 2, 2), (2, 2, 1), "flat", True),
                 ((6, 2, 2), (3, 2, 1), "flat", True), ((4, 2, 2), (2, 2, 1), "flat", False),
                 ((4, 2, 2), (2, 1, 1), "3d", True), ((4, 2, 2), (2, 2, 1), "3d", True),
                 ((6, 2, 2), (3, 2, 1), "3d", True)]


@pytest.mark.parametrize("shape,parts,kernel,overlap", SOLVE_N_CASES)
def test_sharded_solve_n_matches_jax(shape, parts, kernel, overlap):
    """Blocked states element for element against the JAX package's
    ShardedPaddedWave, with its x-face overlap on and off (the port has
    the one path), and the global grid against its single-device
    LinearWave.solve."""
    jm, tm = jax_model(shape, 4), torch_model(shape, 4)
    js = JSharded(jm, parts, tile_x=16, kernel=kernel, overlap_x=overlap)
    ts = ShardedPaddedWave(tm, parts, tile_x=16, kernel=kernel)
    assert ts.layout == type(ts.layout)(**{
        f: getattr(js.layout, f) for f in ("shape", "p", "tile_x", "z_align", "halo")})
    ju, jv, _ = js.solve_n(0.0, DT, NSTEPS)
    tu, tv, _ = ts.solve_n(0.0, DT, NSTEPS)
    assert max_rel(blocked_to_numpy(tu, parts), np.asarray(ju)) <= TOL
    assert max_rel(blocked_to_numpy(tv, parts), np.asarray(jv)) <= TOL
    u1, v1, _ = jm.solve(0.0, NSTEPS * DT, DT)
    assert max_rel(ts.to_global(tu), np.asarray(u1)) <= TOL
    assert max_rel(ts.to_global(tv), np.asarray(v1)) <= TOL


def test_sharded_solve_n_from_a_random_state_matches_single_device():
    """solve_n from a random global state (every interface busy from the
    first stage) against the single-device padded solve_n of the JAX
    package."""
    shape, parts = (6, 4, 2), (3, 2, 1)
    jm, tm = jax_model(shape, 2), torch_model(shape, 2)
    ts = ShardedPaddedWave(tm, parts, tile_x=16)
    jp = JPadded(jm, tile_x=16)
    rng = np.random.default_rng(7)
    g = [rng.standard_normal(jm.ops.grid_shape) for _ in range(2)]
    tu, tv, _ = ts.solve_n(0.0, DT, NSTEPS, ts.from_global(g[0]), ts.from_global(g[1]))
    ju, jv = jp.solve_n(0.0, DT, NSTEPS, jp.from_grid(jnp.asarray(g[0])),
                        jp.from_grid(jnp.asarray(g[1])))
    assert max_rel(ts.to_global(tu), np.asarray(jp.to_grid(ju))) <= TOL
    assert max_rel(ts.to_global(tv), np.asarray(jp.to_grid(jv))) <= TOL


def test_sharded_solve_n_interface_planes_bitwise():
    """The per-stage halo-add leaves both copies of each interface plane
    bitwise equal (the two sums add the same two numbers)."""
    ts = ShardedPaddedWave(torch_model((4, 2, 2), 4), (2, 2, 1), tile_x=16)
    tu, tv, _ = ts.solve_n(0.0, DT, NSTEPS)
    inter = ts.layout.interior
    for by in range(2):
        lo, hi = tv[ts.mesh.index(0, by, 0)][inter], tv[ts.mesh.index(1, by, 0)][inter]
        assert torch.equal(lo[-1], hi[0])
    assert float(tv[0][inter][-1].abs().max()) > 0.0
