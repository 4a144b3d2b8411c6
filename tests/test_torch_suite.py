"""The port's benchmark suite (``benchmarks/suite.py``) on the CPU: its
entries against the JAX suite's list, the runner with each module's
``run`` stubbed and over real modules at tiny sizes, the headline record's
two-point arithmetic and its solves against the JAX package, the
streaming fields' percentage of a ceiling against the JAX formula, and the
CSR matrix that ``apps/kernel_times.py --library`` times beside kernels B,
E and F against their plain versions."""

import inspect
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wave_fenics_tpu.benchmarks import common as jcommon
from wave_fenics_tpu.benchmarks import suite as jsuite
from wave_fenics_tpu.models.linear_wave_padded import PaddedLinearWave as JPadded
from wave_fenics_tpu.models.planar3d import planar3d_case as j_planar3d_case
from wave_fenics_tpu_torch.benchmarks import (
    cg_bench,
    common,
    general_solve,
    operators_bench,
    scatter_bench,
    suite,
    tsmm,
)
from wave_fenics_tpu_torch.models.linear_wave_padded import PaddedLinearWave

ROOT = Path(__file__).resolve().parents[1]
MODULES = {"tsmm": tsmm, "operators_bench": operators_bench, "cg_bench": cg_bench,
           "scatter_bench": scatter_bench, "general_solve": general_solve}
BENCH_PY_DEGREE = 4  # bench.py's --degree default, which its suite entries keep


def _value(token: str):
    for kind in (int, float):
        try:
            return kind(token)
        except ValueError:
            pass
    return token


def _kwargs(args) -> dict:
    """A JAX entry's CLI flags as the kwargs of the port's ``run``."""
    out, key = {}, None
    for tok in args:
        if tok.startswith("--"):
            key = tok[2:].replace("-", "_")
            out[key] = []
        else:
            out[key].append(_value(tok))
    return {k: True if not v else v[0] if len(v) == 1 else tuple(v)
            for k, v in out.items()}


def _jax_entries(monkeypatch, argv) -> list:
    """The JAX suite's (module, kwargs) list for ``argv``: its ``_run``
    records each call and runs nothing; ``--platform`` dropped and
    ``bench.py`` mapped to ``headline``."""
    calls = []
    monkeypatch.setattr(jsuite, "_run", lambda out, acc, mod, *a: calls.append((mod, a)))
    monkeypatch.setattr(sys, "argv", ["suite", *argv])
    jsuite.main()
    got = []
    for mod, args in calls:
        kw = _kwargs(args)
        kw.pop("platform")
        if mod == "bench.py":
            mod = "headline"
            kw = dict(cells=kw["cells"], degree=BENCH_PY_DEGREE, steps=kw["steps"],
                      solver=kw["solver"])
        got.append((mod, kw))
    return got


@pytest.mark.parametrize("argv,quick,degrees,card", [
    ([], False, suite.DEFAULT_DEGREES, True),
    (["--quick"], True, suite.DEFAULT_DEGREES, True),
    (["--degrees", "2", "4"], False, (2, 4), True),
    (["--quick", "--degrees", "2", "4"], True, (2, 4), True),
    (["--platform", "cpu"], False, suite.DEFAULT_DEGREES, False),
    (["--quick", "--platform", "cpu"], True, suite.DEFAULT_DEGREES, False),
])
def test_entries_equal_the_jax_suites(monkeypatch, capsys, argv, quick, degrees, card):
    """One for one, in order: the port's entries and the JAX suite's calls
    (a real chip in JAX is a card here; ``--platform cpu`` drops the
    headline in both)."""
    want = _jax_entries(monkeypatch, argv)
    got = suite.entries(quick, degrees, card=card)
    assert got == want
    assert sum(m == "headline" for m, _ in got) == (3 if card else 0)


@pytest.mark.parametrize("quick", [False, True])
def test_entries_bind_to_their_runs(quick):
    """Every entry's kwargs (with the suite's device) bind to its module's
    ``run`` (or ``headline``)."""
    for mod, kw in suite.entries(quick):
        fn = suite.headline if mod == "headline" else MODULES[mod].run
        inspect.signature(fn).bind(**kw, device="cpu")


def _stub_run(name, doc, seen, fail=None):
    """A ``run`` that records how many results the document held when it
    was called, and raises ``fail`` if given."""

    def run(**kw):
        seen.append((name, len(json.loads(doc.read_text())["results"])
                     if doc.exists() else 0, kw))
        if fail is not None:
            raise fail
        return {"metric": f"{name} {kw.get('op', '')}", "device": kw["device"]}

    return run


def _stubbed(monkeypatch, tmp_path, todo, fails=None):
    doc = tmp_path / "doc.json"
    seen = []
    for name, mod in MODULES.items():
        monkeypatch.setattr(mod, "run", _stub_run(name, doc, seen, (fails or {}).get(name)))
    monkeypatch.setattr(suite, "entries", lambda quick, degrees, card: todo)
    return doc, seen


def test_runner_rewrites_the_document_after_each_entry(monkeypatch, tmp_path, capsys):
    todo = [("tsmm", dict(reps=2)), ("operators_bench", dict(op="stiffness")),
            ("cg_bench", dict(size=2)), ("scatter_bench", dict(mode="local"))]
    doc, seen = _stubbed(monkeypatch, tmp_path, todo)
    summary = suite.main(["--out", str(doc), "--device", "cpu"])
    # entry i ran with the document holding the i records before it
    assert [(n, k) for n, k, _ in seen] == [(m, i) for i, (m, _) in enumerate(todo)]
    assert [kw for _, _, kw in seen] == [{**kw, "device": "cpu"} for _, kw in todo]
    results = json.loads(doc.read_text())["results"]
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(x) for x in lines[:-1]] == results
    assert json.loads(lines[-1]) == summary
    assert summary["n"] == 4 and summary["errors"] == 0


def test_runner_records_an_error_and_exits_1(monkeypatch, tmp_path, capsys):
    """An entry that raises becomes the JAX suite's error record (500
    characters); the entries after it still run, the document holds them
    all, and the suite exits 1 after its summary."""
    todo = [("operators_bench", dict(op="stiffness", size=16, degree=2, reps=10)),
            ("cg_bench", dict(size=16, degree=2, precond=True)),
            ("tsmm", dict(reps=2))]
    doc, seen = _stubbed(monkeypatch, tmp_path, todo,
                         fails={"cg_bench": RuntimeError("x" * 900)})
    with pytest.raises(SystemExit) as e:
        suite.main(["--out", str(doc), "--device", "cpu"])
    assert e.value.code == 1
    assert [n for n, _, _ in seen] == ["operators_bench", "cg_bench", "tsmm"]
    results = json.loads(doc.read_text())["results"]
    assert results[1] == {"metric": "cg_bench --size 16 --degree 2 --precond",
                          "error": ("RuntimeError: " + "x" * 900)[:500]}
    assert len(results[1]["error"]) == 500
    assert "error" not in results[0] and "error" not in results[2]
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (summary["n"], summary["errors"]) == (3, 1)


def test_summary_keys_and_the_headline_it_picks(monkeypatch, tmp_path, capsys):
    """The headline is the last record with both ``value`` and
    ``pct_of_measured_ceiling``: a later record with only the latter, and an
    earlier one with only the former, are passed over."""
    recs = {"padded": {"metric": "p", "value": 1.0},
            "step": {"metric": "s", "value": 3.0, "pct_of_measured_ceiling": 9.5},
            "fused": {"metric": "f", "value": 2.0}}
    todo = [("headline", dict(solver="padded")), ("headline", dict(solver="step")),
            ("operators_bench", dict(op="stiffness")), ("headline", dict(solver="fused"))]
    doc, _ = _stubbed(monkeypatch, tmp_path, todo)
    monkeypatch.setattr(operators_bench, "run", lambda **kw: {
        "metric": "stiffness matvec", "effective_gbps": 5.0,
        "pct_of_measured_ceiling": 0.2})
    monkeypatch.setattr(suite, "headline", lambda solver, device: recs[solver])
    summary = suite.main(["--out", str(doc), "--device", "cpu"])
    assert set(summary) == {"suite", "n", "errors", "headline_gdof_steps_per_s",
                            "headline_pct_of_measured_ceiling", "seconds", "card",
                            "stream_ceiling_gbps"}
    assert (summary["headline_gdof_steps_per_s"],
            summary["headline_pct_of_measured_ceiling"]) == (3.0, 9.5)
    assert (summary["suite"], summary["n"], summary["errors"]) == (str(doc), 4, 0)
    assert summary["card"] == "cpu" and summary["stream_ceiling_gbps"] is None
    assert summary["seconds"] > 0


def test_default_out_is_not_the_jax_suites_file(monkeypatch, tmp_path, capsys):
    """``BENCH_SUITE.json`` is the JAX suite's recorded output: the port
    writes ``BENCH_SUITE_torch.json``, which git ignores."""
    monkeypatch.chdir(tmp_path)
    _stubbed(monkeypatch, tmp_path, [("tsmm", dict(reps=2))])
    summary = suite.main(["--device", "cpu"])
    assert summary["suite"] == suite.DEFAULT_OUT == "BENCH_SUITE_torch.json"
    assert (tmp_path / "BENCH_SUITE_torch.json").exists()
    assert not (tmp_path / "BENCH_SUITE.json").exists()
    assert "BENCH_SUITE_torch.json" in (ROOT / ".gitignore").read_text().splitlines()


def test_no_card_no_run(monkeypatch, tmp_path):
    """``--device cuda`` without a card raises before any entry runs."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    doc, seen = _stubbed(monkeypatch, tmp_path, [("tsmm", dict(reps=2))])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        suite.main(["--out", str(doc)])
    assert not seen and not doc.exists()


def _fixed_window(fn, n, device):
    """Each window still runs fn n times, but costs 1 ms a call plus 5 ms."""
    for _ in range(n):
        fn()
    return n * 1e-3 + 5e-3


# real modules at tiny sizes on the plain versions
SHORT = [
    ("tsmm", dict(ncells=40, degree=2, reps=8, check=True)),
    ("operators_bench", dict(op="stiffness", size=2, degree=2, reps=8, check=True)),
    ("operators_bench", dict(op="bp1-mass", size=2, degree=2, reps=8)),
    ("operators_bench", dict(op="stiffness-general", size=2, degree=2, reps=8, check=True)),
    ("cg_bench", dict(size=2, degree=2, reps=8)),
    ("cg_bench", dict(op="general", size=2, degree=2, reps=8, precond=True)),
    ("cg_bench", dict(size=2, degree=2, reps=8, ndev=2, dtype="f64", rtol=1e-3)),
    ("scatter_bench", dict(mode="local", size=2, degree=2, reps=8, check=True)),
    ("scatter_bench", dict(mode="halo", size=2, degree=2, reps=8, ndev=2)),
    ("scatter_bench", dict(mode="general-halo", size=2, degree=2, reps=8, ndev=2,
                           exchange="ppermute")),
    ("general_solve", dict(size=2, degree=2, steps=4, reps=8)),
]
HOST_CLOCK = {"setup_s"}  # seconds on the host's clock, outside the windows


def test_real_runner_records_equal_the_modules_own(monkeypatch, tmp_path, capsys):
    """The runner over real modules records what each module's own ``run``
    returns for the same arguments, apart from the host clock's set-up
    seconds."""
    monkeypatch.setattr(common, "_window", _fixed_window)
    doc = tmp_path / "doc.json"
    results = suite.run_entries(SHORT, str(doc), "cpu")
    assert json.loads(doc.read_text())["results"] == results
    for (mod, kw), got in zip(SHORT, results):
        assert "error" not in got, got
        want = MODULES[mod].run(**kw, device="cpu")
        assert set(got) == set(want)
        assert {k: v for k, v in got.items() if k not in HOST_CLOCK} == \
            {k: v for k, v in want.items() if k not in HOST_CLOCK}, mod
        assert got["device"] == "cpu" and "pct_of_measured_ceiling" not in got


@pytest.fixture
def steps_run(monkeypatch):
    """The step counts of every padded solve, and windows that cost 1 ms a
    step plus 5 ms."""
    runs = []
    for name in ("solve_n", "solve_fused_n", "solve_step_n"):
        orig = getattr(PaddedLinearWave, name)

        def counted(self, t0, dt, nsteps, *a, _orig=orig, **kw):
            runs.append(nsteps)
            return _orig(self, t0, dt, nsteps, *a, **kw)

        monkeypatch.setattr(PaddedLinearWave, name, counted)

    def window(fn, n, device):
        k0 = len(runs)
        for _ in range(n):
            fn()
        return sum(runs[k0:]) * 1e-3 + 5e-3

    monkeypatch.setattr(common, "_window", window)
    return runs


@pytest.mark.parametrize("solver", ["padded", "fused", "step"])
def test_headline_two_point(steps_run, solver):
    """The warm-up call, three windows of ``steps`` and three of ``n_lo``,
    each from the zero state: the difference over steps - n_lo is exactly
    1 ms a step. ``step`` adds its byte model's effective_gbps; on the CPU
    no record carries a percentage of a ceiling, and none ``vs_baseline``."""
    r = suite.headline(cells=(4, 2, 2), degree=4, steps=8, solver=solver, device="cpu")
    assert steps_run == [8, 8, 8, 8, 2, 2, 2]
    assert r["timing"] == "two-point (8-2 steps)"
    ndofs = 17 * 9 * 9
    assert r["metric"] == f"planar3d RK4 GDoF*steps/s (p=4, {ndofs} dofs, 1 device, {solver})"
    assert abs(r["ms_per_step"] - 1.0) <= 1e-9
    assert abs(r["value"] - ndofs / 1e-3 / 1e9) <= 1e-9 * r["value"]
    assert r["unit"] == "GDoF*steps/s" and r["device"] == "cpu" and r["dtype"] == "f32"
    assert r["tile_x"] == suite.HEADLINE_TILE[solver]
    assert "vs_baseline" not in r and "pct_of_measured_ceiling" not in r
    if solver == "step":
        pm, _, _ = suite.headline_solver((4, 2, 2), 4, solver, "cpu")
        nbytes = 2 * (ndofs + int(np.prod(pm.layout.padded_shape))) * 4
        assert suite.step_bytes(pm) == nbytes
        assert abs(r["effective_gbps"] - nbytes / 1e-3 / 1e9) <= 1e-9 * r["effective_gbps"]
    else:
        assert "effective_gbps" not in r


def test_headline_single_window(monkeypatch, steps_run):
    """A long window no slower than the short one, or n_lo >= steps: one
    window over its steps, labelled single-window."""
    monkeypatch.setattr(common, "_window", lambda fn, n, device: (fn(), 0.012)[1])
    r = suite.headline(cells=(4, 2, 2), degree=4, steps=8, solver="padded", device="cpu")
    assert r["timing"] == "single-window (8 steps)"
    assert abs(r["ms_per_step"] - 12.0 / 8) <= 1e-12
    steps_run.clear()
    r = suite.headline(cells=(4, 2, 2), degree=4, steps=2, solver="padded", device="cpu")
    assert steps_run == [2, 2, 2, 2]
    assert r["timing"] == "single-window (2 steps)"


@pytest.mark.parametrize("cells", [(64, 32, 32), (32, 16, 16)])
@pytest.mark.parametrize("solver", ["padded", "fused", "step"])
def test_headline_solvers_apply_at_the_suites_sizes(cells, solver):
    """Each solver applies at its tile at the full and the quick headline
    cells (p = 4): the model has no ``*_unavailable`` reason and B's and
    D's launch geometry accepts the layout."""
    pm, dt, _ = suite.headline_solver(cells, 4, solver, "cpu")
    assert pm.layout.tile_x == suite.HEADLINE_TILE[solver]
    assert pm.stage_unavailable is None and pm.step_unavailable is None
    from wave_fenics_tpu_torch.ops import wave

    u = torch.zeros(pm.layout.padded_shape)
    wave.flat_launch_args(u, u, pm.layout, pm.stencil)
    wave.rk_stage_launch_args(*([u] * 10), 0.1, 0.1, 0.1, pm.layout, pm.base.c0,
                              pm.stencil, pm.face_w1, pm.face_w2, pm.src_x, pm.abc_x)


def test_headline_rejects_an_unknown_solver():
    with pytest.raises(ValueError, match="--solver"):
        suite.headline(cells=(4, 2, 2), solver="lf", device="cpu")


@pytest.mark.parametrize("solver,jax_solve", [("padded", "solve_n"),
                                              ("fused", "solve_fused_n"),
                                              ("step", "solve_step_n")])
def test_headline_solve_matches_jax(solver, jax_solve):
    """The solve a headline record times leaves, in f64, the state that the
    JAX package's PaddedLinearWave leaves after the same steps from the
    zero state, on the same case and tile."""
    pm, dt, solve = suite.headline_solver((4, 2, 2), 4, solver, "cpu", "f64")
    jcase = j_planar3d_case(ncells=(4, 2, 2), domain_length=0.1, degree=4,
                            dtype=jnp.float64)
    assert dt == jcase.dt
    jpm = JPadded(jcase.model, tile_x=suite.HEADLINE_TILE[solver])
    assert tuple(jpm.layout.padded_shape) == tuple(pm.layout.padded_shape)
    ju, jv = getattr(jpm, jax_solve)(0.0, jcase.dt, 12)[:2]
    u, v = solve(12)
    ju, jv = np.asarray(ju), np.asarray(jv)
    vmax = float(np.abs(jv).max())
    assert vmax > 0
    assert float(np.abs(u.numpy() - ju).max()) <= 1e-12 * float(np.abs(ju).max())
    assert float(np.abs(v.numpy() - jv).max()) <= 1e-12 * vmax


@pytest.mark.parametrize("nbytes,t", [(68.4e6, 0.3717e-3), (1.0e9, 0.35e-3),
                                      (2.5e6, 1.23e-5), (123456789.0, 0.0421)])
@pytest.mark.parametrize("ceiling", [314.1, 2913.7])
def test_streaming_fields_pct_is_jaxs(monkeypatch, nbytes, t, ceiling):
    """With one ceiling patched into both packages, the port's
    pct_of_measured_ceiling is the JAX formula with its rounding; its
    effective_gbps is the same rate, unrounded."""
    monkeypatch.setattr(jcommon, "MEASURED_STREAM_CEILING_GBPS", ceiling)
    monkeypatch.setattr(common, "stream_ceiling_gbps", lambda device: ceiling)
    want = jcommon.streaming_fields(nbytes, t)
    got = common.streaming_fields(nbytes, t, "cuda")
    assert got["pct_of_measured_ceiling"] == want["pct_of_measured_ceiling"]
    assert round(got["effective_gbps"], 1) == want["effective_gbps"]


def test_streaming_fields_leave_the_pct_out_on_the_cpu(monkeypatch):
    """No ceiling on the CPU, as the JAX package has none when its constant
    is None: effective_gbps alone."""
    assert common.stream_ceiling_gbps("cpu") is None
    assert common.streaming_fields(1e9, 1e-3, "cpu") == {"effective_gbps": 1000.0}
    assert common.streaming_fields(1e9, 1e-3, torch.device("cpu")) == {"effective_gbps": 1000.0}
    monkeypatch.setattr(jcommon, "MEASURED_STREAM_CEILING_GBPS", None)
    assert set(jcommon.streaming_fields(1e9, 1e-3)) == {"effective_gbps"}


@pytest.mark.parametrize("k,cells,p", [("B", (4, 2, 3), 4), ("B", (3, 2, 2), 1),
                                       ("E", (3, 2, 2), 10), ("E", (2, 3, 2), 9),
                                       ("F", (3, 4, 2), 4), ("F", (2, 2, 2), 6)])
def test_csr_operator_is_the_kernels_function(k, cells, p):
    """``apps/kernel_times.py::csr_operator``, the one PyTorch call's matrix
    beside kernels B, E and F, computes their plain versions' function on the
    dof grid (f64, 1e-12), with int32 indices and at most 3p + 4 entries a
    row on average."""
    from wave_fenics_tpu_torch.apps import kernel_times, planar3d_app
    from wave_fenics_tpu_torch.core.mesh import box_mesh
    from wave_fenics_tpu_torch.ops import stiffness, wave
    from wave_fenics_tpu_torch.ops.operators import StructuredOperators

    rng = np.random.default_rng(7)
    if k == "F":
        ops = StructuredOperators(box_mesh(cells, (1.0, 1.0, 1.0)), p, dtype=torch.float64)
        x = torch.as_tensor(rng.standard_normal(ops.grid_shape))
        y = ops.stiffness(x, 1500.0)
        C = kernel_times.csr_operator(cells, p, ops.mesh.h, 1500.0, inv_mass=False)
    else:
        _, pm = planar3d_app.build(cells, p, "f64", None, "cpu")
        assert pm.kernel == ("3d" if k == "E" else "flat")
        x = torch.as_tensor(rng.standard_normal(pm.layout.shape))
        xp = pm.layout.pad(x)
        y = pm.layout.unpad(wave.apply_flat_plain(xp, pm.layout, pm.flat_tables) if k == "B"
                            else wave.apply_slab_plain(xp, pm.layout, pm.slab_tables))
        C = kernel_times.csr_operator(cells, p, pm.base.mesh.h, pm.base.c0, inv_mass=True)
    y = y.numpy().ravel()
    assert C.indices.dtype == np.int32 and C.indptr.dtype == np.int32
    assert C.nnz <= (3 * p + 4) * C.shape[0]
    assert np.abs(C @ x.numpy().ravel() - y).max() <= 1e-12 * np.abs(y).max()
    if k == "F":
        tabs = stiffness.GridStiffnessTables(*[torch.as_tensor(t) for t in
                                               stiffness.stiffness_grid_tables(
                                                   ops._sepA, ops._seplines, ops.grid_shape,
                                                   p, -1500.0**2, torch.float64)])
        yk = stiffness.stiffness_grid_plain(x, tabs, p).numpy().ravel()
        assert np.abs(C @ x.numpy().ravel() - yk).max() <= 1e-12 * np.abs(yk).max()
