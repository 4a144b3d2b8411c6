"""The app's sharded branch (``--ndev``) and ``cg_bench --ndev`` on the
CPU (the plain versions on every block), float64: each against the same
run on one device at 1e-12, the JAX app's ``solver_path`` strings, the
global-grid snapshots and output, and the options that raise.
"""

import json

import numpy as np
import pytest

from wave_fenics_tpu_torch.apps import planar3d_app
from wave_fenics_tpu_torch.benchmarks import cg_bench
from wave_fenics_tpu_torch.core.io import read_xdmf_attributes
from wave_fenics_tpu_torch.utils.checkpoint import CheckpointManager
from wave_fenics_tpu_torch.utils.config import SimulationConfig

CELLS = (4, 2, 2)
TOL = 1e-12


def _run(ndev, integrator="rk4", steps=6, cells=CELLS, degree=4, **kw):
    return planar3d_app.run(cells=cells, degree=degree, dtype="f64", device="cpu",
                            steps=steps, integrator=integrator, ndev=ndev,
                            return_state=True, **kw)


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


# (ndev, integrator, the JAX app's solver_path)
APP_CASES = [(2, "rk4", "sharded value-halo RK4 STEP kernel"),
             (4, "rk4", "sharded value-halo RK4 STEP kernel"),
             (4, "leapfrog", "sharded value-halo leapfrog STEP kernel"),
             (2, "leapfrog", "sharded value-halo leapfrog STEP kernel")]


@pytest.mark.parametrize("ndev,integrator,path", APP_CASES)
def test_app_ndev_matches_one_device(tmp_path, ndev, integrator, path):
    """--ndev N on decompose3d(N) blocks against the one-device app, with
    the global grid written by --output."""
    out1, u1, v1 = _run(1, integrator)
    out, u, v = _run(ndev, integrator, output=str(tmp_path / "o.xdmf"))
    assert out["solver_path"] == path and out["ndev"] == ndev
    assert out["nsteps"] == out1["nsteps"] and out["dt"] == out1["dt"]
    assert len(u) == ndev
    f = read_xdmf_attributes(str(tmp_path / "o.xdmf"))
    case, pm = planar3d_app.build(cells=CELLS, dtype="f64", device="cpu")
    assert _rel(f["u"], pm.to_grid(u1).numpy()) <= TOL
    assert _rel(f["v"], pm.to_grid(v1).numpy()) <= TOL
    assert abs(out["u_norm"] - out1["u_norm"]) <= 1e-6 * out1["u_norm"]


def test_app_ndev_per_stage_path_where_the_guard_refuses(tmp_path):
    """Three blocks along x with one cell each: the value-halo paths do not
    apply; RK4 takes the per-stage halo-add as the JAX app does, and
    leapfrog raises naming the guard."""
    outs = [_run(n, cells=(3, 2, 2), degree=2, output=str(tmp_path / f"{n}.xdmf"))[0]
            for n in (1, 3)]
    assert outs[1]["solver_path"] == "sharded per-stage halo-add RK4"
    f1, f3 = (read_xdmf_attributes(str(tmp_path / f"{n}.xdmf")) for n in (1, 3))
    assert _rel(f3["u"], f1["u"]) <= TOL and _rel(f3["v"], f1["v"]) <= TOL
    with pytest.raises(ValueError, match="one-hop"):
        _run(3, "leapfrog", cells=(3, 2, 2), degree=2)


@pytest.mark.parametrize("kw,match", [(dict(lean=False), "--full-tableau"),
                                      (dict(two_step=True), "--two-step")])
def test_app_ndev_one_device_options_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        _run(2, **kw)


@pytest.mark.parametrize("integrator", ["rk4", "leapfrog"])
def test_app_ndev_checkpoints_hold_the_global_grid(tmp_path, integrator):
    """A sharded run in chunks of 2 steps with snapshots, stopped at step 4
    and resumed: the same final grid as one unchunked run, each snapshot
    the global dof grid (which a one-device run resumes from too)."""
    def cfg():
        c = SimulationConfig()
        c.domain.ncells, c.run.dtype = CELLS, "f64"
        c.time.integrator = integrator
        c.run.checkpoint_every_steps = 2
        return c

    ck = str(tmp_path / "ck")
    _, u0, v0 = planar3d_app.run(cfg(), device="cpu", steps=6, ndev=4,
                                 return_state=True)
    planar3d_app.run(cfg(), device="cpu", steps=4, ndev=4, checkpoint_dir=ck)
    step, us, vs, t, _ = CheckpointManager(ck, 2).restore()
    case, pm = planar3d_app.build(cells=CELLS, dtype="f64", device="cpu")
    assert step == 2 and us.shape == case.model.ops.grid_shape
    out, u, v = planar3d_app.run(cfg(), device="cpu", steps=6, ndev=4,
                                 checkpoint_dir=ck, return_state=True)
    assert out["resumed_from_step"] == 2
    out1, u1, v1 = planar3d_app.run(cfg(), device="cpu", steps=6, checkpoint_dir=ck,
                                    return_state=True)
    assert out1["resumed_from_step"] == 4
    sw = planar3d_app.ShardedPaddedWave(case.model, (2, 2, 1))
    lay = sw.halo_layout("step" if integrator == "rk4" else "lf")
    ref = sw.to_global(v0, lay)
    assert _rel(sw.to_global(v, lay), ref) <= TOL
    assert _rel(pm.to_grid(v1).numpy(), ref) <= TOL


def test_main_ndev_prints_the_record(capsys):
    planar3d_app.main(["--cells", "4", "2", "2", "--dtype", "f64", "--device", "cpu",
                       "--steps", "2", "--ndev", "2"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["solver_path"] == "sharded value-halo RK4 STEP kernel" and rec["ndev"] == 2


@pytest.mark.parametrize("ndev,precond", [(2, False), (8, False), (4, True)])
def test_cg_bench_ndev_matches_one_device(ndev, precond):
    """cg_bench --ndev: the spectral mass on ShardedLinearWave, CG with the
    weighted dot, against the one-device CG from the same b."""
    r = cg_bench.run(size=2, degree=2, device="cpu", dtype="f64", reps=2, ndev=ndev,
                     rtol=1e-10, precond=precond)
    assert r["metric"].startswith("CG spectral sharded mass") and r["ndev"] == ndev
    assert abs(r["iters"] - r["iters_single_device"]) <= 1
    assert r["max_rel_solution_diff"] < 1e-9 and r["ndofs"] == 5**3
    one = cg_bench.run(op="spectral", size=2, degree=2, device="cpu", dtype="f64",
                       reps=2, rtol=1e-10, precond=precond)
    assert one["iters"] == r["iters_single_device"]
