"""The port's models and app: reference semantics against the JAX package,
the planar3d case constants, the no-fallback rules, and that the port never
imports JAX."""

import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import jax_model, max_rel, padded_pair, torch_model
from wave_fenics_tpu.models.planar3d import planar3d_case as j_planar3d_case
from wave_fenics_tpu_torch.apps import planar3d_app
from wave_fenics_tpu_torch.models.linear_wave_padded import PaddedLinearWave
from wave_fenics_tpu_torch.models.planar3d import planar3d_case

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("p", [2, 4])
def test_linear_wave_solve_matches_jax(p):
    jm, tm = jax_model(p=p), torch_model(p=p)
    dt = 1e-9
    ju, jv, jn = jm.solve(0.0, 25 * dt, dt)
    u, v, n = tm.solve(0.0, 25 * dt, dt)
    assert n == jn
    assert max_rel(u, np.asarray(ju)) <= 1e-12
    assert max_rel(v, np.asarray(jv)) <= 1e-12


def test_source_amplitude_matches_jax():
    jm, tm = jax_model(), torch_model()
    for t in np.linspace(0.0, 10 * tm.period, 37):
        np.testing.assert_allclose(
            tm.g_amplitude(float(t)), float(jm.g_amplitude(jnp.asarray(t))),
            rtol=1e-13, atol=1e-9,
        )


@pytest.mark.parametrize("kw", [
    dict(ncells=(64, 32, 32), domain_length=0.1),
    dict(ncells=(16, 2, 2), domain_length=6e-3),
    dict(ncells=(4, 2, 2), domain_length=0.01, degree=2),
])
def test_planar3d_case_constants(kw):
    jc = j_planar3d_case(**kw, dtype=jnp.float64)
    c = planar3d_case(**kw, dtype=torch.float64)
    assert c.dt == jc.dt
    assert c.steps_per_period == jc.steps_per_period
    assert c.nsteps == jc.nsteps
    assert (c.t0, c.tf) == (jc.t0, jc.tf)
    assert c.model.ops.ndofs == jc.model.ops.ndofs
    if kw["ncells"] == (64, 32, 32):
        assert (c.nsteps, c.model.ops.ndofs) == (1489, 4_276_737)


def test_solve_step_n_raises_without_x_faces():
    """No fallback: y-face tags put the step path out of reach, and
    solve_step_n raises instead of running another solver."""
    pm = PaddedLinearWave(torch_model(tags={1: (2,), 2: (3,)}), tile_x=16)
    assert pm.step_tables is None
    with pytest.raises(ValueError, match="x-faces"):
        pm.solve_step_n(0.0, 1e-9, 2)
    # the f1 path still applies
    u, v = pm.solve_n(0.0, 1e-9, 2)
    assert float(v.abs().max()) > 0.0


def test_solve_step_n_raises_when_tile_below_halo():
    pm = PaddedLinearWave(torch_model(p=8), tile_x=16)  # off0(8) = 24 > 16
    with pytest.raises(ValueError, match="slab halo"):
        pm.solve_step_n(0.0, 1e-9, 1)


def test_high_degree_raises():
    """p > 8 needs the 3D-slab kernel, which is not ported: raise."""
    with pytest.raises(ValueError, match="kernel E"):
        PaddedLinearWave(torch_model(shape=(2, 1, 1), p=9))


def test_app_device_cuda_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        planar3d_app.run(cells=(4, 2, 2), device="cuda", steps=1)


def test_app_cpu_run_matches_model(capsys):
    """The app on the CPU (plain versions) at a tiny size: the JAX app's
    keys, and the same state as the model's own solve_step_n."""
    planar3d_app.main(["--cells", "4", "2", "2", "--dtype", "f64",
                       "--device", "cpu", "--steps", "6"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("ndofs", "nsteps", "steps_per_period", "solve_seconds",
                "gdof_steps_per_s", "u_norm", "solver_path",
                "build_seconds", "warmup_seconds"):
        assert key in out
    assert out["nsteps"] == 6
    case, pm = planar3d_app.build(cells=(4, 2, 2), dtype="f64", device="cpu")
    u, _, _ = pm.solve_step_n(case.t0, case.dt, 6)
    assert out["u_norm"] == pytest.approx(float(torch.linalg.norm(u.float())),
                                          rel=1e-6)
    assert out["u_norm"] > 0.0


def test_port_never_imports_jax():
    """Importing the port, the app included, loads neither JAX nor the JAX
    package (run in a fresh interpreter: this test process has both)."""
    code = (
        "import sys\n"
        "import wave_fenics_tpu_torch.apps.planar3d_app\n"
        "import wave_fenics_tpu_torch.apps.profile_step\n"
        "import wave_fenics_tpu_torch.convert\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'wave_fenics_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_padded_pair_same_layout():
    jpm, pm = padded_pair(p=4, tile_x=16)
    assert pm.layout.padded_shape == jpm.layout.padded_shape
    assert pm.layout.tile_x == jpm.layout.tile_x
