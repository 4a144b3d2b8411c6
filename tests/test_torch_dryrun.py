"""The port's multi-block dry run (``apps/dryrun.py::dryrun_multichip``) on
the CPU in float64: every check of the JAX dry run at 8 blocks, the
one-device solve against the JAX package's ``LinearWave.solve`` on the same
case and the CG iteration count against the JAX package's ``cg`` on the same
model and b (1e-12 relative; iterations equal); the 2-step RK4 guard
recorded where it applies, and an error that is not the guard's
propagating. (The JAX dry run itself is not run here: it took 53 s on
8 virtual CPU devices.)"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_cases import max_rel

from wave_fenics_tpu.core.mesh import HexMesh as JHexMesh
from wave_fenics_tpu.models.general_wave import GeneralLinearWave as JGeneralLinearWave
from wave_fenics_tpu.models.planar3d import planar3d_case as jplanar3d_case
from wave_fenics_tpu.solvers.cg import cg as jcg
from wave_fenics_tpu_torch.apps import dryrun
from wave_fenics_tpu_torch.core.mesh import HEX_FACES, box_mesh
from wave_fenics_tpu_torch.parallel.sharded_general import ShardedGeneralWave
from wave_fenics_tpu_torch.parallel.sharded_padded import ShardedPaddedWave

F64 = torch.float64
TOL = 1e-12
CHECKS = ["step == stage (v)", "step == stage (u)", "stage == one device (v)",
          "general == one device (v)", "allgather == ppermute (v)",
          "general leapfrog == one device (v)", "lf == one device (v)",
          "lf2 == one device (v)", "step2 == one device (v)",
          "distributed CG == one device (x)"]


@pytest.fixture(scope="module")
def eight():
    return dryrun.dryrun_multichip(8, device="cpu", dtype=F64)


def test_every_check_at_8_blocks(eight):
    """Each check of the JAX dry run ran, in its order, and in f64 each holds
    to 1e-12 of max|reference| (the dry run's own bound is JAX's 1e-4)."""
    r = eight
    assert r["parts"] == (2, 2, 2) and r["cells"] == (4, 4, 4) and r["nsteps"] == 3
    assert list(r["checks"]) == CHECKS
    assert max(r["checks"].values()) <= TOL
    assert set(r["v_max"]) == {"stage", "step", "general"}
    assert min(r["v_max"].values()) > 0.0
    assert set(r["exchange_modes"]) == {"allgather", "ppermute"}
    assert r["step2_unavailable"] is None
    assert r["rk42_note"] == "sharded 2-step RK4 kernel == single-device verified"
    assert r["cg_iters"] == r["cg_iters_one_device"] > 0
    assert r["summary"].startswith("dryrun_multichip ok: mesh=(2, 2, 2), cells=(4, 4, 4)")


def test_one_device_solve_matches_jax(eight):
    """The dry run's one-device ``case.model.solve`` against the JAX package's
    on the same case (planar3d, (4,4,4) cells, 0.01 m, f64, 3 steps)."""
    case = jplanar3d_case(ncells=(4, 4, 4), domain_length=0.01, dtype=jnp.float64)
    _, v, n = case.model.solve(0.0, 3 * case.dt, case.dt)
    assert int(n) == 3
    assert eight["one_device_v"].shape == np.asarray(v).shape
    assert max_rel(eight["one_device_v"], np.asarray(v)) <= TOL


def test_cg_iterations_match_jax(eight):
    """The JAX package's cg on the same model (the box's hex mesh, x-face
    tags), b (default_rng(0)) and tau, as the JAX dry run runs it
    (__graft_entry__.py:167-185): the dry run's iteration count."""
    hm = box_mesh((4, 4, 4), (0.01, 0.01, 0.01)).to_hex_mesh()

    def quads(x0):
        on = np.abs(hm.points[:, 0] - x0) < 1e-12
        faces = hm.cells[:, HEX_FACES].reshape(-1, 4)
        return faces[on[faces].all(axis=1)]

    jm = JGeneralLinearWave(mesh=JHexMesh(points=hm.points, cells=hm.cells), p=4,
                            facet_tags={1: quads(0.0), 2: quads(0.01)}, dtype=jnp.float64)
    bg = np.random.default_rng(0).standard_normal(jm.ndofs)
    tau = eight["cg_tau"]
    m1 = jnp.asarray(jm.m)
    _, k, _ = jcg(lambda z: m1 * z - tau * jm.ops.stiffness_indexed(z, jm.c0),
                  jnp.asarray(bg), kmax=50, rtol=1e-5, precond=lambda r: r / m1)
    assert int(k) == eight["cg_iters"]


def test_step2_guard_is_recorded():
    """On (3,1,1) blocks of 2 cells, solve_step2_n's guard applies (>= 5
    cells a block on an axis split 3 ways): the run records its reason,
    skips that check and raises nothing; every other check runs."""
    r = dryrun.dryrun_multichip(3, device="cpu", dtype=F64)
    why = ShardedPaddedWave(dryrun.planar3d_case(ncells=(6, 2, 2), domain_length=0.01,
                                                 dtype=F64, device="cpu").model,
                            (3, 1, 1)).step2_unavailable
    assert why is not None and ">= 5 cells a block" in why
    assert r["step2_unavailable"] == why and why in r["rk42_note"]
    assert list(r["checks"]) == [c for c in CHECKS if not c.startswith("step2")]
    assert max(r["checks"].values()) <= TOL


def test_an_error_that_is_not_the_guard_propagates(monkeypatch):
    """A ValueError from the 2-step path where its guard does not apply is
    not taken for the guard (the JAX dry run's broad except would)."""
    def broken(self, *args, **kw):
        raise ValueError("a fault of the path")

    monkeypatch.setattr(ShardedPaddedWave, "solve_step2_n", broken)
    with pytest.raises(ValueError, match="a fault of the path"):
        dryrun.dryrun_multichip(2, device="cpu", dtype=F64)


def test_cg_iteration_mismatch_raises(monkeypatch):
    solve = ShardedGeneralWave.cg_solve

    def one_more(self, *args, **kw):
        x, k, r = solve(self, *args, **kw)
        return x, k + 1, r

    monkeypatch.setattr(ShardedGeneralWave, "cg_solve", one_more)
    with pytest.raises(AssertionError, match="distributed CG took"):
        dryrun.dryrun_multichip(2, device="cpu", dtype=F64)


def test_cli_prints_the_summary(capsys):
    r = dryrun.main(["2", "--device", "cpu", "--dtype", "f64"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == r["summary"]
    assert r["parts"] == (2, 1, 1) and r["dtype"] == "float64"
