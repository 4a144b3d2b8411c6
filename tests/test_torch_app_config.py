"""The app's entry point: the port's SimulationConfig against the JAX
package's (the same JSON, the same case), the fields the port cannot honour
yet, the imported-mesh fields and the output path, snapshots in the JAX package's .npz format both ways, and the chunked,
checkpointed and resumed runs against one unchunked run (CPU, f64)."""

import json
import os

import numpy as np
import pytest
import torch

import _torch_cases  # noqa: F401  (one torch thread per test process)
from wave_fenics_tpu.utils import checkpoint as jcheckpoint
from wave_fenics_tpu.utils.config import SimulationConfig as JSimulationConfig
from wave_fenics_tpu_torch.apps import planar3d_app
from wave_fenics_tpu_torch.benchmarks.general_solve import perturbed_box
from wave_fenics_tpu_torch.core.dofmap import StructuredDofGrid
from wave_fenics_tpu_torch.core.io import (
    read_xdmf_attributes,
    read_xdmf_geometry,
    write_xdmf_mesh,
    write_xdmf_meshtags,
)
from wave_fenics_tpu_torch.models.general_wave import GeneralLinearWave
from wave_fenics_tpu_torch.utils import checkpoint
from wave_fenics_tpu_torch.utils.config import SimulationConfig

TOL = 1e-12


def _jax_config_json():
    cfg = JSimulationConfig()
    cfg.domain.ncells = (6, 2, 2)
    cfg.domain.degree = 3
    cfg.physics.source_frequency = 0.6e6
    cfg.time.cfl = 0.4
    cfg.time.n_tail_periods = 3.0
    cfg.run.dtype = "f64"
    cfg.run.checkpoint_every_steps = 7
    return cfg, cfg.to_json()


def test_jax_config_file_loads_and_builds_the_same_case():
    jcfg, text = _jax_config_json()
    cfg = SimulationConfig.from_json(text)
    assert json.loads(cfg.to_json()) == json.loads(text)
    jc, c = jcfg.build_case(), cfg.build_case(device="cpu")
    assert (c.dt, c.nsteps, c.steps_per_period) == (jc.dt, jc.nsteps, jc.steps_per_period)
    assert c.model.ops.ndofs == jc.model.ops.ndofs
    assert c.model.dtype == torch.float64 and c.model.p == 3


@pytest.mark.parametrize("fields,subject", [
    # run.ndev > 1 runs blocks of a box or RCB parts of an imported mesh;
    # fewer than one device raises on either
    ((("run", "ndev", 0), ("domain", "mesh_path", "mesh.xdmf")), "at least 1"),
    # run.dtype names one of the three types (bf16 runs every path: the
    # box and the imported mesh, on one device or several)
    ((("run", "dtype", "f16"), ("run", "ndev", 2)), "f32, f64 or bf16"),
])
def test_unsupported_fields_raise(fields, subject):
    cfg = SimulationConfig()
    for section, name, value in fields:
        setattr(getattr(cfg, section), name, value)
    with pytest.raises(ValueError, match=subject):
        cfg.build_case(device="cpu")


def _imported_config(tmp_path, degree=2):
    """A config on a perturbed (4, 2, 2)-cell box written as XDMF: tag 1 on
    the x-low facets, tag 2 on the x-high ones."""
    hm, tags = perturbed_box((4, 2, 2), h=0.002)
    write_xdmf_mesh(str(tmp_path / "mesh.xdmf"), hm)
    write_xdmf_meshtags(str(tmp_path / "tags.xdmf"), hm,
                        np.concatenate([tags[1], tags[2]]),
                        [1] * len(tags[1]) + [2] * len(tags[2]))
    cfg = SimulationConfig()
    cfg.domain.mesh_path = str(tmp_path / "mesh.xdmf")
    cfg.domain.meshtags_path = str(tmp_path / "tags.xdmf")
    cfg.domain.degree = degree
    cfg.run.dtype = "f64"
    return cfg


def test_mesh_path_builds_the_imported_case(tmp_path):
    """domain.mesh_path (with meshtags_path) builds planar3d_case_xdmf; the
    box fields ncells/domain_length/width are ignored, as in the JAX
    package."""
    cfg = _imported_config(tmp_path)
    cfg.domain.ncells = (7, 7, 7)
    cfg.domain.width = 1.0
    case = cfg.build_case(device="cpu")
    assert isinstance(case.model, GeneralLinearWave)
    assert case.model.ndofs == 9 * 5 * 5 and case.model.dtype == torch.float64
    assert float(case.model.W1.abs().max()) > 0 and float(case.model.W2.abs().max()) > 0
    assert case.tf == pytest.approx(0.008 / 1500.0 + 8 / 0.5e6, rel=1e-12)


def test_meshtags_path_alone_raises_and_mesh_path_alone_has_no_tags(tmp_path):
    cfg = SimulationConfig()
    cfg.domain.meshtags_path = "tags.xdmf"
    with pytest.raises(ValueError, match="meshtags_path needs domain.mesh_path"):
        cfg.build_case(device="cpu")
    cfg = _imported_config(tmp_path)
    cfg.domain.meshtags_path = None
    model = cfg.build_case(device="cpu").model
    assert float(model.W1.abs().max()) == 0.0 == float(model.W2.abs().max())


def test_tags_are_honoured_on_an_imported_mesh(tmp_path):
    """source_tag/abc_tag swap the planes on an imported mesh (the JAX
    package honours them there); on a box they still raise."""
    cfg = _imported_config(tmp_path)
    ref = cfg.build_case(device="cpu").model
    cfg.domain.source_tag, cfg.domain.abc_tag = 2, 1
    swapped = cfg.build_case(device="cpu").model
    assert torch.equal(swapped.W1, ref.W2) and torch.equal(swapped.W2, ref.W1)


def test_output_path_writes_the_box_state(tmp_path):
    """run.output_path on the box branch: the unpadded grid of the final
    state in a rectilinear XDMF file, binary heavy data, the node lines
    StructuredDofGrid's, the write timed apart from the solve."""
    cfg = SimulationConfig()
    cfg.domain.ncells = (4, 2, 2)
    cfg.run.dtype = "f64"
    cfg.run.output_path = str(tmp_path / "out" / "box.xdmf")
    out, u, v = planar3d_app.run(cfg, device="cpu", steps=5, return_state=True)
    assert out["output_seconds"] > 0 and out["read_seconds"] == 0.0
    case, pm = planar3d_app.build(cells=(4, 2, 2), dtype="f64", device="cpu")
    fields = read_xdmf_attributes(cfg.run.output_path)
    np.testing.assert_array_equal(fields["u"], pm.to_grid(u).numpy())
    np.testing.assert_array_equal(fields["v"], pm.to_grid(v).numpy())
    dg = StructuredDofGrid(case.model.mesh, case.model.p)
    z, y, x = read_xdmf_geometry(cfg.run.output_path)
    for a, d in zip((x, y, z), range(3)):
        np.testing.assert_array_equal(a, dg.axis_coords(d))
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        "box.u.bin", "box.v.bin", "box.x.bin", "box.xdmf", "box.y.bin", "box.z.bin"]


@pytest.mark.parametrize("section,name,value", [
    ("physics", "window_periods", 3.0),
    ("time", "t0", 1e-6),
    ("domain", "source_tag", 3),
    ("domain", "abc_tag", 4),
    ("run", "log_every_steps", 10),
])
def test_fields_the_reference_ignores_raise(section, name, value):
    """The JAX package's build_case drops these fields; the port raises on
    a value other than the default and names the field."""
    cfg = SimulationConfig()
    setattr(getattr(cfg, section), name, value)
    with pytest.raises(ValueError, match=f"{section}.{name}"):
        cfg.build_case(device="cpu")


def test_jax_default_config_loads_and_builds():
    text = JSimulationConfig().to_json()
    cfg = SimulationConfig.from_json(text)
    assert json.loads(cfg.to_json()) == json.loads(text)
    case = cfg.build_case(device="cpu")
    assert case.model.ops.ndofs == 4_276_737 and case.nsteps == 1489


def test_run_leaves_the_callers_config_unchanged():
    cfg = SimulationConfig()
    out = planar3d_app.run(cfg, cells=(4, 2, 2), degree=2, dtype="f64",
                           integrator="leapfrog", steps=1, device="cpu")
    assert out["nsteps"] == 1 and out["integrator"] == "leapfrog"
    assert cfg == SimulationConfig()


def test_force_padded_is_accepted():
    cfg = SimulationConfig()
    cfg.domain.ncells = (4, 2, 2)
    cfg.run.force_padded = True
    assert cfg.build_case(device="cpu").model.ops.ndofs > 0


def test_snapshots_cross_between_packages(tmp_path):
    rng = np.random.default_rng(0)
    u, v = rng.standard_normal((3, 4, 5)), rng.standard_normal((3, 4, 5))
    jcheckpoint.save_state(str(tmp_path / "x.npz"), u, v, 1.25e-6, {"step": 7})
    lu, lv, t, meta = checkpoint.load_state(str(tmp_path / "x.npz"))
    np.testing.assert_array_equal(lu, u)
    np.testing.assert_array_equal(lv, v)
    assert (t, meta) == (1.25e-6, {"step": 7})
    checkpoint.save_state(str(tmp_path / "y"), torch.as_tensor(u), torch.as_tensor(v),
                          2.5e-6, {"step": 9})
    ju, jv, jt, jmeta = jcheckpoint.load_state(str(tmp_path / "y.npz"))
    np.testing.assert_array_equal(ju, u)
    np.testing.assert_array_equal(jv, v)
    assert (jt, jmeta) == (2.5e-6, {"step": 9})


def test_orbax_manager_directory_raises(tmp_path):
    """A directory of the JAX package's manager (orbax snapshots) is not
    read as an empty one: the port's manager raises and names orbax."""
    ck = str(tmp_path / "ck")
    jcheckpoint.CheckpointManager(ck, every_steps=2).save(
        2, np.ones(3), np.zeros(3), 1e-6)
    assert jcheckpoint._HAVE_ORBAX and os.listdir(ck) == ["step_000000002"]
    cm = checkpoint.CheckpointManager(ck)
    with pytest.raises(ValueError, match="orbax"):
        cm.restore()
    with pytest.raises(ValueError, match="orbax"):
        cm.latest_step()


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    cm = checkpoint.CheckpointManager(str(tmp_path / "ck"), every_steps=2, keep=2)
    assert cm.restore() is None
    for step in (2, 4, 6):
        cm.save(step, np.full(3, step), np.zeros(3), step * 0.5)
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_000000004.npz",
                                                  "step_000000006.npz"]
    step, u, _, t, _ = cm.restore()
    assert step == 6 and t == 3.0 and u[0] == 6


# (integrator, two_step, tile_x, chunk): the two-step path with an odd
# chunk, whose every chunk ends on the lean step kernel
PATHS = [("rk4", False, None, 4), ("leapfrog", False, None, 4), ("rk4", True, 24, 3)]


def _config(integrator, chunk):
    cfg = SimulationConfig()
    cfg.domain.ncells = (4, 2, 2)
    cfg.run.dtype = "f64"
    cfg.time.integrator = integrator
    cfg.run.checkpoint_every_steps = chunk
    return cfg


def _run(cfg, two_step, tile_x, steps, checkpoint_dir=None):
    return planar3d_app.run(cfg, device="cpu", steps=steps, tile_x=tile_x,
                            two_step=two_step, checkpoint_dir=checkpoint_dir,
                            return_state=True)


def _assert_close(u, v, u_ref, v_ref):
    vmax = float(v_ref.abs().max())
    assert vmax > 0.0
    assert float((u - u_ref).abs().max()) <= TOL * max(vmax, 1.0)
    assert float((v - v_ref).abs().max()) <= TOL * vmax


@pytest.mark.parametrize("integrator,two_step,tile_x,chunk", PATHS)
def test_chunked_run_matches_unchunked(tmp_path, integrator, two_step, tile_x, chunk):
    """11 steps in chunks with a snapshot after each chunk but the last:
    the state of one unchunked run."""
    _, u0, v0 = _run(_config(integrator, chunk), two_step, tile_x, 11)
    ck = tmp_path / "ck"
    out, u, v = _run(_config(integrator, chunk), two_step, tile_x, 11, str(ck))
    _assert_close(u, v, u0, v0)
    saved = list(range(chunk, 11, chunk))
    assert sorted(os.listdir(ck)) == [f"step_{s:09d}.npz" for s in saved[-3:]]
    assert out["resumed_from_step"] == 0 and out["nsteps"] == 11
    _, lu, _, t, _ = checkpoint.CheckpointManager(str(ck)).restore()
    assert lu.shape == tuple(u.shape)
    assert t == pytest.approx(saved[-1] * out["dt"], rel=1e-14)


@pytest.mark.parametrize("integrator,two_step,tile_x,chunk", PATHS)
def test_resumed_run_matches_uninterrupted(tmp_path, integrator, two_step, tile_x,
                                           chunk):
    """A run stopped after 5 steps and restarted for 11 resumes from its
    last snapshot and ends on the uninterrupted run's state."""
    _, u0, v0 = _run(_config(integrator, chunk), two_step, tile_x, 11)
    ck = str(tmp_path / "ck")
    _run(_config(integrator, chunk), two_step, tile_x, 5, ck)
    out, u, v = _run(_config(integrator, chunk), two_step, tile_x, 11, ck)
    assert out["resumed_from_step"] == chunk
    _assert_close(u, v, u0, v0)


def test_main_with_config_file_and_checkpoint_dir(tmp_path, capsys):
    """The command line: a config file the JAX package wrote, a checkpoint
    directory, a resumed second call; flags override the file."""
    cfg = JSimulationConfig()
    cfg.domain.ncells = (4, 2, 2)
    cfg.domain.degree = 2
    cfg.run.dtype = "f64"
    cfg.run.checkpoint_every_steps = 3
    path = tmp_path / "cfg.json"
    path.write_text(cfg.to_json())
    argv = ["--config", str(path), "--checkpoint-dir", str(tmp_path / "ck"),
            "--device", "cpu", "--steps", "7", "--degree", "4"]
    planar3d_app.main(argv)
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    planar3d_app.main(argv)
    second = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("ndofs", "nsteps", "steps_per_period", "solve_seconds",
                "gdof_steps_per_s", "u_norm", "solver_path", "compile_seconds",
                "warmup_seconds"):
        assert key in first
    assert first["ndofs"] == 17 * 9 * 9  # degree 4 from the flag
    assert (first["resumed_from_step"], second["resumed_from_step"]) == (0, 6)
    assert second["u_norm"] == pytest.approx(first["u_norm"], rel=1e-12)


def test_two_step_raises_where_kernel_j_does_not_apply():
    """No fallback: --two-step at tile 16 and p = 4 (below the 6p slab
    halo), at p > 8 (the 3D-slab layout), and with leapfrog."""
    with pytest.raises(ValueError, match="6p slab halo"):
        planar3d_app.run(cells=(4, 2, 2), device="cpu", steps=2, tile_x=16,
                         two_step=True)
    with pytest.raises(ValueError, match="needs the flat layout"):
        planar3d_app.run(cells=(2, 1, 1), degree=9, device="cpu", steps=2,
                         two_step=True)
    with pytest.raises(ValueError, match="kernel I"):
        planar3d_app.run(cells=(4, 2, 2), device="cpu", steps=2,
                         integrator="leapfrog", two_step=True)


@pytest.mark.parametrize("integrator", ["rk4", "leapfrog"])
def test_high_degree_app_path_is_kernel_e(integrator):
    """p = 9: the app's RK4 on f1 and leapfrog on force run kernel E's
    plain version on the CPU, as the JAX app's padded XLA paths do."""
    out, u, _ = planar3d_app.run(cells=(2, 1, 1), degree=9, dtype="f64", device="cpu",
                                 steps=3, integrator=integrator, return_state=True)
    assert out["solver_path"] == ("plain torch RK4 on f1 (CPU)" if integrator == "rk4"
                                  else "plain torch leapfrog on force (CPU)")
    assert out["u_norm"] > 0.0 and tuple(u.shape) == (64, 32, 128)
