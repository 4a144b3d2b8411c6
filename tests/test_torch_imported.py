"""The imported-mesh workflow of the port against the JAX package (CPU,
float64): ``from_xdmf``/``planar3d_case_xdmf`` on XDMF files both packages
read, the app's general branch (RK4 and leapfrog, chunked and resumed, with
``--output``), probe recording on box and general models, the energy
diagnostics, and the two examples.

Solves agree to 1e-12 relative to max|ref| (only association order
differs); tables to 1e-14; dt, step counts and files exactly. Meshes are
the port's ``general_solve.perturbed_box`` (seeded, not affine), written as
inline-XML XDMF, which both packages read."""

import json
import math
import xml.etree.ElementTree as ET

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import jax_model, max_rel, torch_model
from wave_fenics_tpu.apps import planar3d_app as japp
from wave_fenics_tpu.models import diagnostics as jdiag
from wave_fenics_tpu.models import general_wave as jgw
from wave_fenics_tpu.models import linear_wave as jlw
from wave_fenics_tpu.models.planar3d import planar3d_case_xdmf as jcase_xdmf
from wave_fenics_tpu.utils.config import SimulationConfig as JSimulationConfig
from wave_fenics_tpu_torch.apps import planar3d_app
from wave_fenics_tpu_torch.benchmarks.general_solve import perturbed_box
from wave_fenics_tpu_torch.core import io
from wave_fenics_tpu_torch.examples import hifu_with_output, imported_mesh_hifu
from wave_fenics_tpu_torch.models import diagnostics
from wave_fenics_tpu_torch.models import general_wave as gw
from wave_fenics_tpu_torch.models import linear_wave as lw
from wave_fenics_tpu_torch.models.planar3d import planar3d_case_xdmf
from wave_fenics_tpu_torch.utils.config import SimulationConfig

F64 = torch.float64
TOL = 1e-12


def _write_mesh(d, cells=(4, 2, 2), fmt="xml"):
    """(mesh_path, tags_path) of a perturbed box with 2 mm cells: tag 1 on
    the x-low facets, tag 2 on the x-high ones."""
    d.mkdir(parents=True, exist_ok=True)
    hm, tags = perturbed_box(cells, h=0.002)
    mp, tp = str(d / "mesh.xdmf"), str(d / "tags.xdmf")
    io.write_xdmf_mesh(mp, hm, data_format=fmt)
    io.write_xdmf_meshtags(tp, hm, np.concatenate([tags[1], tags[2]]),
                           [1] * len(tags[1]) + [2] * len(tags[2]), data_format=fmt)
    return mp, tp


@pytest.fixture
def mesh_files(tmp_path):
    return _write_mesh(tmp_path / "mesh")


@pytest.mark.parametrize("p", [2, 3])
def test_planar3d_case_xdmf_matches_jax(mesh_files, p):
    """dt, the step counts exactly; m, W1, W2 to 1e-14. p = 3 has asymmetric
    interior facet nodes, so a winding mix-up would show in W1, W2."""
    c = planar3d_case_xdmf(*mesh_files, degree=p, dtype=F64, device="cpu")
    jc = jcase_xdmf(*mesh_files, degree=p, dtype=jnp.float64)
    assert (c.dt, c.tf, c.nsteps, c.steps_per_period) == (jc.dt, jc.tf, jc.nsteps,
                                                          jc.steps_per_period)
    assert c.model.ndofs == jc.model.ndofs
    for name in ("m", "W1", "W2"):
        got, want = getattr(c.model, name), getattr(jc.model, name)
        assert max_rel(got, want) <= 1e-14, name
        assert float(np.abs(np.asarray(want)).max()) > 0
    assert c.read_seconds > 0


def test_from_xdmf_honours_the_tags_and_matches_jax(mesh_files):
    """source_tag/abc_tag swap the two planes in both packages."""
    m = gw.from_xdmf(*mesh_files, p=3, dtype=F64, device="cpu", source_tag=2, abc_tag=1)
    jm = jgw.from_xdmf(*mesh_files, p=3, dtype=jnp.float64, source_tag=2, abc_tag=1)
    assert max_rel(m.W1, jm.W1) <= 1e-14 and max_rel(m.W2, jm.W2) <= 1e-14
    ref = gw.from_xdmf(*mesh_files, p=3, dtype=F64, device="cpu")
    assert torch.equal(m.W1, ref.W2) and torch.equal(m.W2, ref.W1)


def test_meshtags_of_another_mesh_raise(tmp_path):
    """Tags whose facets are no exterior faces of the mesh raise instead of
    giving zero or interior weights."""
    mp, _ = _write_mesh(tmp_path / "a", cells=(4, 2, 2))
    _, tp = _write_mesh(tmp_path / "b", cells=(2, 3, 2))
    with pytest.raises(ValueError, match="not exterior faces"):
        gw.from_xdmf(mp, tp, p=2, dtype=F64, device="cpu")


def _cfg(pkg, mesh_files, integrator, p=2):
    cfg = (SimulationConfig if pkg == "port" else JSimulationConfig)()
    cfg.domain.mesh_path, cfg.domain.meshtags_path = mesh_files
    cfg.domain.degree = p
    cfg.run.dtype = "f64"
    cfg.time.integrator = integrator
    cfg.time.n_tail_periods = 0.25
    return cfg


@pytest.mark.parametrize("integrator", ["rk4", "leapfrog"])
def test_app_imported_matches_jax_app(tmp_path, mesh_files, integrator):
    """The whole slice: the port's app on the CPU against the JAX app's run
    on the same config, each writing its final state with --output. The
    states agree to 1e-12 relative (the JAX app's file read back), nsteps
    and the output time exactly; u_norm, an f32 norm in both apps, to
    1e-6."""
    jcfg = _cfg("jax", mesh_files, integrator)
    jcfg.run.output_path = str(tmp_path / "jax" / "out.xdmf")
    (tmp_path / "jax").mkdir()
    jout = japp.run(jcfg)
    out, u, v = planar3d_app.run(_cfg("port", mesh_files, integrator), device="cpu",
                                 output=str(tmp_path / "port" / "out.xdmf"),
                                 return_state=True)
    assert out["nsteps"] == jout["nsteps"] > 10 and out["ndofs"] == jout["ndofs"]
    assert out["u_norm"] == pytest.approx(jout["u_norm"], rel=1e-6)
    assert "kernel K's plain version" in out["solver_path"]
    assert out["output_seconds"] > 0 and out["read_seconds"] > 0
    jf = io.read_xdmf_attributes(jcfg.run.output_path)
    pf = io.read_xdmf_attributes(str(tmp_path / "port" / "out.xdmf"))
    assert max_rel(u, jf["u"]) <= TOL and max_rel(v, jf["v"]) <= TOL
    np.testing.assert_array_equal(pf["u"], u.numpy())
    np.testing.assert_array_equal(pf["v"], v.numpy())
    times = [ET.parse(p).getroot().find(".//Time").get("Value")
             for p in (jcfg.run.output_path, str(tmp_path / "port" / "out.xdmf"))]
    assert times[0] == times[1]


@pytest.mark.parametrize("integrator", ["rk4", "leapfrog"])
def test_app_imported_chunked_and_resumed(tmp_path, mesh_files, integrator):
    """Chunks of 7 with snapshots, then a resumed call after deleting the
    newest snapshot: both end on the unchunked run's state (1e-12)."""
    _, u0, v0 = planar3d_app.run(_cfg("port", mesh_files, integrator), device="cpu",
                                 return_state=True)
    cfg = _cfg("port", mesh_files, integrator)
    cfg.run.checkpoint_every_steps = 7
    ck = tmp_path / "ck"
    out1, u1, v1 = planar3d_app.run(cfg, device="cpu", checkpoint_dir=str(ck),
                                    return_state=True)
    assert max_rel(u1, u0) <= TOL and max_rel(v1, v0) <= TOL
    snaps = sorted(ck.iterdir())
    snaps[-1].unlink()
    out2, u2, v2 = planar3d_app.run(cfg, device="cpu", checkpoint_dir=str(ck),
                                    return_state=True)
    assert out2["resumed_from_step"] == int(snaps[-2].stem[len("step_"):]) > 0
    assert out2["nsteps"] == out1["nsteps"]
    assert max_rel(u2, u0) <= TOL and max_rel(v2, v0) <= TOL


def test_app_imported_snapshot_of_another_mesh_raises(tmp_path, mesh_files):
    cfg = _cfg("port", mesh_files, "rk4")
    ck = tmp_path / "ck"
    from wave_fenics_tpu_torch.utils.checkpoint import CheckpointManager
    CheckpointManager(str(ck)).save(3, np.zeros(5), np.zeros(5), 1e-7)
    with pytest.raises(ValueError, match="dofs"):
        planar3d_app.run(cfg, device="cpu", checkpoint_dir=str(ck))


@pytest.mark.parametrize("flags,names", [
    (["--two-step"], "--two-step"), (["--full-tableau"], "--full-tableau"),
    (["--tile-x", "24"], "--tile-x"), (["--cells", "4", "2", "2"], "--cells")])
def test_box_flags_with_mesh_raise(mesh_files, flags, names):
    argv = ["--mesh", mesh_files[0], "--meshtags", mesh_files[1], "--device", "cpu",
            "--steps", "1", *flags]
    with pytest.raises(ValueError, match=f"{names}: box-branch options"):
        planar3d_app.main(argv)


def test_main_imported_mesh_output(tmp_path, mesh_files, capsys):
    """The command line of the imported-mesh mode: one JSON line naming the
    path, the state written as a valid mesh file."""
    out_path = str(tmp_path / "out.xdmf")
    planar3d_app.main(["--mesh", mesh_files[0], "--meshtags", mesh_files[1], "--device",
                       "cpu", "--dtype", "f64", "--degree", "2", "--steps", "3",
                       "--output", out_path])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["nsteps"] == 3 and out["output_seconds"] > 0
    assert out["solver_path"] == "plain torch general RK4 on kernel K's plain version (CPU)"
    m = io.read_xdmf(out_path)
    case = planar3d_case_xdmf(*mesh_files, degree=2, dtype=F64, device="cpu")
    np.testing.assert_array_equal(m.points, case.model.dofs.dof_coords)
    assert m.ncells == case.model.dofs.ncells * 8


# -- recording and diagnostics ---------------------------------------------

def _general_pair(p=2):
    hm, tags = perturbed_box((4, 2, 2), h=0.002)
    m = gw.GeneralLinearWave(hm, p, tags, dtype=F64, device="cpu")
    from wave_fenics_tpu.core.mesh import HexMesh as JHexMesh
    jm = jgw.GeneralLinearWave(mesh=JHexMesh(points=hm.points, cells=hm.cells), p=p,
                               facet_tags=tags, dtype=jnp.float64)
    return m, jm


@pytest.mark.parametrize("integrator", ["rk4", "leapfrog"])
def test_general_solve_recording_matches_jax(integrator):
    m, jm = _general_pair()
    pts = np.asarray(m.dofs.dof_coords)[[7, 101, 160]] + 1e-5
    np.testing.assert_array_equal(gw.probe_dofs(m, pts), jgw.probe_dofs(jm, pts))
    dt = 1e-8 * (0.71 if integrator == "leapfrog" else 1.0)
    u, v, s = gw.solve_recording(m, 0.0, dt, 25, pts, integrator=integrator)
    ju, jv, js = jgw.solve_recording(jm, 0.0, dt, 25, pts, integrator=integrator)
    assert s.shape == (25, 3) and float(s.abs().max()) > 0
    assert max_rel(s, js) <= TOL and max_rel(u, ju) <= TOL and max_rel(v, jv) <= TOL
    ur, vr = m.solve_n(0.0, dt, 25, integrator=integrator)
    assert torch.equal(u, ur) and torch.equal(v, vr)
    assert torch.equal(s[-1], u[torch.as_tensor(gw.probe_dofs(m, pts))])


def test_box_solve_recording_matches_jax():
    m, jm = torch_model(p=4), jax_model(p=4)
    pts = np.array([[0.001, 0.002, 0.0025], [0.006, 0.0, 0.005], [0.0093, 0.004, 0.001]])
    for got, want in zip(lw.probe_indices(m, pts), jlw.probe_indices(jm, pts)):
        np.testing.assert_array_equal(got, want)
    u, v, s = lw.solve_recording(m, 0.0, 1e-9, 25, pts)
    ju, jv, js = jlw.solve_recording(jm, 0.0, 1e-9, 25, pts)
    assert s.shape == (25, 3) and float(s.abs().max()) > 0
    assert max_rel(s, js) <= TOL and max_rel(u, ju) <= TOL and max_rel(v, jv) <= TOL


def test_recording_reads_nothing_back_per_step():
    """The recording loop keeps its samples on the state's device: no
    .item(), float(), .cpu(), .tolist() or .numpy() of a floating-point
    tensor (the state, a sample, a field) while it runs; each would be a
    host sync per step on a card. (Kernel K's colour bounds are int32
    tensors that stay on the host by design, ops/general.py.)"""
    from torch.overrides import TorchFunctionMode

    reads = {torch.Tensor.item, torch.Tensor.cpu, torch.Tensor.tolist,
             torch.Tensor.numpy, torch.Tensor.__float__, torch.Tensor.__bool__}

    class Spy(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in reads and args[0].is_floating_point():
                self.seen.append(func)
            return func(*args, **(kwargs or {}))

    m, _ = _general_pair()
    bm = torch_model(p=2)
    pts = np.asarray(m.dofs.dof_coords)[[3, 50]]
    u0, v0 = m.zero_state()
    bu0, bv0 = bm.zero_state()
    with Spy() as spy:
        for integrator in ("rk4", "leapfrog"):
            *_, s = gw.solve_recording(m, 0.0, 1e-8, 6, pts, u0, v0, integrator=integrator)
        *_, bs = lw.solve_recording(bm, 0.0, 1e-9, 6, [[0.002, 0.001, 0.001]], bu0, bv0)
    assert spy.seen == [] and isinstance(s, torch.Tensor) and s.shape == (6, 2)
    assert bs.shape == (6, 1)
    with Spy() as control:  # the spy sees a read
        float(s[0, 0])
    assert control.seen == [torch.Tensor.__float__]


def test_energy_and_l2_norm_match_jax():
    rng = np.random.default_rng(4)
    m, jm = _general_pair(3)
    bm, jbm = torch_model(p=4), jax_model(p=4)
    for tm, jmod, shape in ((m, jm, (m.ndofs,)), (bm, jbm, bm.ops.grid_shape)):
        u, v = rng.standard_normal(shape), rng.standard_normal(shape)
        e = diagnostics.energy(tm, torch.as_tensor(u), torch.as_tensor(v))
        je = jax.jit(lambda a, b, mod=jmod: jdiag.energy(mod, a, b))(u, v)
        n = diagnostics.l2_norm(tm, torch.as_tensor(u))
        jn = jax.jit(lambda a, mod=jmod: jdiag.l2_norm(mod, a))(u)
        assert e.shape == () and abs(float(e) - float(je)) <= TOL * abs(float(je))
        assert abs(float(n) - float(jn)) <= TOL * float(jn)
        assert float(je) > 0 and math.isfinite(float(e))


# -- the examples ------------------------------------------------------------

def test_imported_mesh_example_runs_on_the_cpu(tmp_path, capsys):
    imported_mesh_hifu.main([str(tmp_path), "--device", "cpu", "--steps", "10"])
    assert "ndofs=5577 nsteps=10" in capsys.readouterr().out
    series = np.loadtxt(tmp_path / "probes.csv", delimiter=",", skiprows=1)
    assert series.shape == (10, 3)
    sol = io.read_xdmf_attributes(str(tmp_path / "solution.xdmf"))
    assert sol["u"].shape == (5577,) and np.isfinite(sol["v"]).all()
    assert np.abs(sol["v"]).max() > 0
    assert not list(tmp_path.glob("*.h5"))


def test_hifu_with_output_example_runs_on_the_cpu(tmp_path, capsys):
    hifu_with_output.main([str(tmp_path), "--device", "cpu", "--steps", "12"])
    assert "(12 steps, 5265 dofs)" in capsys.readouterr().out
    series = np.loadtxt(tmp_path / "probes.csv", delimiter=",", skiprows=1)
    assert series.shape == (12, 4)
    last = io.read_xdmf_attributes(str(tmp_path / "fields.xdmf"), "t3")
    assert last["u"].shape == (65, 9, 9) and np.abs(last["u"]).max() > 0
    assert not list(tmp_path.glob("*.h5"))
