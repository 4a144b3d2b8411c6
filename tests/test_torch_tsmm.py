"""The port's ``benchmarks/tsmm.py`` against the JAX package's
``benchmarks/tsmm.py`` on the CPU: the contraction pair in float64 at 1e-12
relative on the same u, the record's fields, and its flop and dof rates at
a fixed cost a call (``common._window`` patched, so the host clock does not
enter)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_cases import max_rel

from wave_fenics_tpu.core.basis import tabulate_1d as jtabulate_1d
from wave_fenics_tpu.ops.element_kernels import interp3 as jinterp3
from wave_fenics_tpu.ops.element_kernels import interp3_t as jinterp3_t
from wave_fenics_tpu_torch.benchmarks import common, tsmm

NCELLS = 64
# the JAX module's record (wave_fenics_tpu/benchmarks/tsmm.py:56-66)
JAX_FIELDS = ("metric", "ncells", "ndofs", "nq", "degree", "dtype", "ms_per_apply",
              "timing", "gflops_ref", "gflops", "gdofs_per_s")


def _fixed_window(fn, n, device):
    """1 ms a call and 5 ms a window: two-point timing then gives exactly 1 ms
    an apply; each window still calls fn n times."""
    for _ in range(n):
        fn()
    return n * 1e-3 + 5e-3


@pytest.mark.parametrize("p", [2, 4])
def test_contraction_matches_jax(p):
    """interp3_t(interp3(u, B), B) on the JAX module's u (default_rng(0)) and
    Gauss rule of exactness 2p + 2, f64, within 1e-12 relative."""
    tab = jtabulate_1d(p, q=2 * p + 2, rule="gauss")
    nd = tab.nd
    u = np.random.default_rng(0).standard_normal((NCELLS, nd, nd, nd))
    want = np.asarray(jinterp3_t(jinterp3(jnp.asarray(u), jnp.asarray(tab.B)),
                                 jnp.asarray(tab.B)))
    got = tsmm.contract(torch.as_tensor(u), torch.as_tensor(tab.B))
    assert got.shape == (NCELLS, nd, nd, nd)
    assert max_rel(got, want) <= 1e-12


@pytest.mark.parametrize("p", [2, 4])
def test_cli_record_matches_jax_formulas(p, capsys, monkeypatch):
    """The CLI's record: the JAX module's fields, and at 1 ms an apply its
    rates as the JAX module computes them (tsmm.py:50-66); f64 against the
    f64 reference exactly."""
    monkeypatch.setattr(common, "_window", _fixed_window)
    tsmm.main(["--ncells", str(NCELLS), "--degree", str(p), "--dtype", "f64",
               "--reps", "8", "--check", "--device", "cpu"])
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(JAX_FIELDS) <= set(r)
    tab = jtabulate_1d(p, q=2 * p + 2, rule="gauss")
    nd1, nq1 = tab.nd, tab.nq
    nd3, nq3 = nd1**3, nq1**3
    t = 1e-3
    flops_ref = 4.0 * NCELLS * nd3 * nd3
    flops_sf = 4.0 * NCELLS * (nq1 * nd1**3 + nq1**2 * nd1**2 + nq1**3 * nd1)
    assert (r["metric"], r["ncells"], r["ndofs"], r["nq"], r["degree"], r["dtype"]) == (
        "tsmm interp+project", NCELLS, nd3, nq3, p, "f64")
    assert r["timing"] == "two-point" and r["device"] == "cpu"
    assert r["ms_per_apply"] == pytest.approx(1.0, rel=1e-12)
    assert r["gflops_ref"] == pytest.approx(flops_ref / t / 1e9, rel=1e-12)
    assert r["gflops"] == pytest.approx(flops_sf / t / 1e9, rel=1e-12)
    assert r["gdofs_per_s"] == pytest.approx(NCELLS * nd3 / t / 1e9, rel=1e-12)
    # one warm-up call, 3 windows of 8 and of 2 calls, the check's call
    assert r["applies"] == 1 + 3 * (8 + 2) + 1
    assert r["max_rel_err_vs_f64"] == 0.0 and r["tf32"] is None


def test_f32_against_f64():
    """f32 on the CPU against the same contraction in f64 (the check the
    card's run makes on its first 1,000 cells), within 1e-6 of max|ref|."""
    r = tsmm.run(ncells=NCELLS, degree=3, reps=2, dtype="f32", device="cpu", check=True)
    assert r["timing"] == "single-window"
    assert 0.0 < r["max_rel_err_vs_f64"] <= 1e-6


def test_flops_count_the_two_models():
    """At the JAX defaults (1e5 cells, p = 4: nd 5, nq 6 a direction) the
    dense model's 6.25 GFLOP and the sum-factorized 1.092 GFLOP an apply."""
    dense, sf = tsmm.flops(100000, 5, 6)
    assert dense == 6.25e9 and sf == 4.0 * 1e5 * (6 * 125 + 36 * 25 + 216 * 5)
