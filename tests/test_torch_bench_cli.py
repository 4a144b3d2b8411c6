"""The port's benchmark CLIs on the CPU at a tiny size (the plain versions):
the JSON record's fields, the f64 checks, and the raise of what waits for
a later slice."""

import json
import time

import numpy as np
import pytest
import torch

from wave_fenics_tpu_torch.benchmarks import cg_bench, common, general_solve, operators_bench


def _main(module, argv, capsys):
    module.main(argv + ["--device", "cpu"])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("op", list(operators_bench.STRUCTURED_OPS))
def test_operators_cli_checks_against_f64(op, capsys):
    r = _main(operators_bench, ["--op", op, "--size", "3", "--degree", "2",
                                "--reps", "2", "--check", "--dtype", "f64"], capsys)
    for key in ("metric", "degree", "ndofs", "dtype", "device", "ms_per_apply",
                "gdofs_per_s", "timing", "effective_gbps", "setup_s"):
        assert key in r
    assert r["ndofs"] == 7**3 and r["device"] == "cpu"
    assert r["timing"] == "single-window"
    assert r["max_rel_err_vs_f64_oracle"] <= 1e-12


def test_operators_cli_f32_two_point(capsys, monkeypatch):
    """The two-point rate through the CLI. The host clock is taken out of the
    outcome: each window still calls the op n times, but costs a fixed 1 ms a
    call plus 5 ms a window, so the difference of the two windows gives
    exactly 1 ms an apply whatever the machine's load."""

    def window(fn, n, device):
        for _ in range(n):
            fn()
        return n * 1e-3 + 5e-3

    monkeypatch.setattr(common, "_window", window)
    r = _main(operators_bench, ["--op", "bp1-mass", "--size", "2", "--degree", "4",
                                "--reps", "8", "--check"], capsys)
    assert r["timing"] == "two-point"
    assert abs(r["ms_per_apply"] - 1.0) <= 1e-9
    assert r["max_rel_err_vs_f64_oracle"] <= 1e-5


@pytest.mark.parametrize("op", list(operators_bench.GENERAL_OPS))
def test_operators_cli_general_ops_check_against_f64(op, capsys):
    """The explicit-dofmap ops (kernel K's plain version on the CPU, and the
    indexed path) against the f64 oracle of a second operator set."""
    r = _main(operators_bench, ["--op", op, "--size", "3", "--degree", "2",
                                "--reps", "2", "--check", "--dtype", "f64"], capsys)
    assert r["ndofs"] == 7**3 and r["applies"] == 1 + 3 * 2 + 1
    assert r["max_rel_err_vs_f64_oracle"] <= 1e-12


@pytest.mark.parametrize("op,precond", [("bp1", False), ("bp1", True),
                                        ("spectral", False), ("spectral", True)])
def test_cg_cli(op, precond, capsys):
    argv = ["--op", op, "--size", "3", "--degree", "2", "--reps", "2",
            "--dtype", "f64"] + (["--precond"] if precond else [])
    r = _main(cg_bench, argv, capsys)
    for key in ("metric", "degree", "ndofs", "iters", "dtype", "precond",
                "device", "ms_total", "timing", "solves", "dofs_iter_per_s", "setup_s"):
        assert key in r
    assert r["ndofs"] == 7**3 and 1 <= r["iters"] <= 50
    assert r["solves"] == 1 + 1 + 3 * 2  # first solve, warm-up, 3 windows of 2
    assert r["rnorm2"] >= 0.0


@pytest.mark.parametrize("precond", [False, True])
def test_cg_cli_general(precond, capsys):
    """CG on the explicit-dofmap Gauss mass (kernel K's mass_gauss mode on a
    card; its plain version here)."""
    argv = ["--op", "general", "--size", "3", "--degree", "2", "--reps", "2",
            "--dtype", "f64"] + (["--precond"] if precond else [])
    r = _main(cg_bench, argv, capsys)
    assert r["ndofs"] == 7**3 and 1 <= r["iters"] <= 50 and r["solves"] == 8
    assert r["rnorm2"] >= 0.0


@pytest.mark.parametrize("integrator", ["rk4", "leapfrog"])
def test_general_solve_cli(integrator, capsys):
    r = _main(general_solve, ["--size", "2", "--degree", "2", "--steps", "3",
                              "--reps", "2", "--dtype", "f64", "--integrator",
                              integrator], capsys)
    assert r["ndofs"] == 5**3 and r["steps"] == 3 and r["timing"] == "single-window"
    assert r["solves"] == 1 + 3 * 2 + 1
    assert r["applies_per_solve"] == (12 if integrator == "rk4" else 4)
    assert 0.0 < r["vmax"] < 1e15 and r["gdof_steps_per_s"] > 0


# --op general --ndev 4 runs (tests/test_torch_parallel_general.py); what
# still raises on that path is a device count below one
@pytest.mark.parametrize("kw,match", [(dict(op="general", ndev=0), "at least 1")])
def test_cg_cli_later_slices_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        cg_bench.run(size=2, degree=2, device="cpu", **kw)


def test_cuda_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cg_bench.run(size=2, degree=2, device="cuda")


@pytest.mark.parametrize("n", [1, 2, 8, 12, 64, 2**15])
def test_decompose3d_matches_jax(n):
    from wave_fenics_tpu.parallel.partition import decompose3d as j_decompose3d

    assert common.decompose3d(n) == j_decompose3d(n)
    assert common.cells_from_args(4, None) == (4, 4, 4)
    assert np.prod(common.cells_from_args(4, int(np.log2(8)))) == 8


@pytest.mark.parametrize("reps,label,calls", [(2, "single-window", 1 + 3 * 2),
                                              (8, "two-point", 1 + 3 * (8 + 2))])
def test_two_point_time_counts_its_calls(reps, label, calls):
    made = []

    def fn():  # long enough that the 8-call window is slower than the 2-call one
        made.append(1)
        time.sleep(1e-4)

    t, got_label, got_calls = common.two_point_time(fn, reps, torch.device("cpu"))
    assert (got_label, got_calls, len(made)) == (label, calls, calls)
    assert t > 0


def test_two_point_time_falls_back_when_the_long_window_is_faster(monkeypatch):
    """Noise that makes the long window faster than the short one gives the
    long window's single-window rate, labelled so, not a clamped difference."""
    monkeypatch.setattr(common, "_window",
                        lambda fn, n, device: 0.010 if n == 40 else 0.012)
    t, label, calls = common.two_point_time(lambda: None, 40, torch.device("cpu"))
    assert (label, calls) == ("single-window", 1 + 3 * (40 + 10))
    assert t == 0.010 / 40
