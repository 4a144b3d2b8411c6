"""The harness on the CPU: every cell of BENCHMARK.json resolves by name,
a new traffic file is found without editing a file, BENCHMARK.json keeps
the benchmark's format, and a whole run at a small size on the port's
plain versions comes out correct, while the control (the port's bf16
path) and a timed path broken underneath come out not correct."""

import json
import re
import shutil

import pytest
import torch

from port_bench import harness

BENCH = json.loads((harness.REPO / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
#: small sizes the plain versions run in seconds
SMALL = {"planar3d-p4": {"cells": [4, 2, 2]}, "bp1-p4-s18": {"cells": [4, 4, 4]}}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _small(workload):
    return SMALL[next(w["config"] for w in BENCH["workloads"] if w["name"] == workload)]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_resolves_by_name(workload):
    cell = harness.load_cell(workload)
    assert cell.config["name"] == cell.workload["config"]
    assert set(cell.limits) and all("limit" in v for v in cell.limits.values())
    names = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    assert set(cell.end_to_end) <= names and "setup_s" in cell.end_to_end
    assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_new_traffic_file_is_found_without_editing_a_file(tmp_path):
    """A later cell adds a traffic file, its limits and a BENCHMARK.json
    entry; the harness finds all of them by name and no file changes."""
    shutil.copytree(harness.ROOT, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "port_bench").rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({
        "name": "planar3d-p4.rk4-five", "config": "planar3d-p4",
        "traffic": "rk4-five", "chips": 1, "why": "RK4 from five seeded states"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "planar3d-p4.rk4" in m.get("workloads", ()):
            m["workloads"].append("planar3d-p4.rk4-five")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((harness.ROOT / "traffic" / "rk4.json").read_text())
    (tmp_path / "port_bench" / "traffic" / "rk4-five.json").write_text(
        json.dumps({**traffic, "inputs": {**traffic["inputs"], "count": 5}}))
    shutil.copy(harness.ROOT / "limits" / "planar3d-p4.rk4.json",
                tmp_path / "port_bench" / "limits" / "planar3d-p4.rk4-five.json")
    cell = harness.load_cell("planar3d-p4.rk4-five", repo=tmp_path)
    assert cell.traffic["inputs"]["count"] == 5
    assert cell.entry.__name__ == "port_bench.entries.box_solve"
    assert set(cell.end_to_end) == set(harness.load_cell("planar3d-p4.rk4").end_to_end)
    assert set(cell.per_layer) == set(harness.load_cell("planar3d-p4.rk4").per_layer)
    for path, data in before.items():
        assert (tmp_path / path).read_bytes() == data


def test_benchmark_json_keeps_its_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"] and 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        for w in m.get("workloads", WORKLOADS):
            assert w in WORKLOADS and harness._applies(e2e[m["moves"]], w)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (harness.ROOT / "metrics" / f"{m['name']}.py").is_file()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("port_bench/configs/")
        assert json.loads((harness.REPO / c["file"]).read_text())["name"] == c["name"]
    names = [c["name"] for c in BENCH["configs"]]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for text in (c["why"] for c in BENCH["configs"] + BENCH["workloads"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("workload", WORKLOADS)
def test_run_is_correct_on_the_plain_versions(workload):
    r = harness.run_cell(workload, 2 ** 31 + 11, 1.5, False, "cpu",
                         overrides=_small(workload))
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    want = set(harness.load_cell(workload).end_to_end)
    if r["attempted"] < 2:  # a percentile needs two solves; a busy CPU may give one
        want.discard("cg_solve_ms_p95")
    assert set(r["metrics"]) == want
    assert all(v["value"] > 0 for v in r["metrics"].values())


@pytest.mark.parametrize("workload", WORKLOADS)
def test_traced_run_on_the_cpu_reports_no_device_metric(workload):
    r = harness.run_cell(workload, 7, 0.2, True, "cpu", overrides=_small(workload))
    assert r["correct"]
    assert set(r["metrics"]) <= {"build_s"}
    assert "busy_s" not in r["device"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload):
    """The control: the port's bf16 path in place of its f32 one."""
    r = harness.run_cell(workload, 2 ** 31 + 12, 0.2, False, "cpu",
                         overrides={**_small(workload), "dtype": "bf16"})
    assert not r["correct"] and r["failed"] >= 1


def _broken_box(monkeypatch, fault):
    from wave_fenics_tpu_torch.models.linear_wave_padded import PaddedLinearWave

    for name in ("solve_step_n", "solve_lf2_n"):
        orig = getattr(PaddedLinearWave, name)

        def broken(self, t0, dt, n, u0=None, v0=None, _orig=orig):
            if fault == "unchanged":  # a step that returns its state unchanged
                return u0.clone(), v0.clone(), n
            u, v, n = _orig(self, t0, dt, n, u0, v0)
            u = u.clone()
            u.view(-1)[u.abs().argmax()] *= 1.1  # one answer altered where produced
            return u, v, n

        monkeypatch.setattr(PaddedLinearWave, name, broken)


def _broken_cg(monkeypatch, fault):
    from wave_fenics_tpu_torch.solvers import cg as cg_mod

    orig = cg_mod.cg

    def broken(matvec, b, **kw):
        if fault == "unchanged":
            return torch.zeros_like(b), kw["kmax"], torch.zeros(())
        x, k, r = orig(matvec, b, **kw)
        x = x.clone()
        x.view(-1)[x.abs().argmax()] *= 1.1
        return x, k, r

    monkeypatch.setattr(cg_mod, "cg", broken)


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    (_broken_cg if "cg" in workload else _broken_box)(monkeypatch, fault)
    r = harness.run_cell(workload, 3, 0.2, False, "cpu", overrides=_small(workload))
    assert not r["correct"] and r["failed"] >= 1
