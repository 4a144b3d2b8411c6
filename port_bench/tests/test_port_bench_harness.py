"""The harness on the CPU: every cell of BENCHMARK.json resolves by name,
a new traffic file and a new configuration are found without editing a
file, BENCHMARK.json keeps the benchmark's format, and a whole run at a
small size on the port's plain versions comes out correct, while the
control (the port's bf16 path) and a timed path broken underneath come
out not correct.

What belongs to one configuration is a file of its own here too, found by
name: ``small/<config>.json`` holds the keys that the configuration's
small size overrides, and ``faults/<entry>.py`` an ``install(monkeypatch,
fault)`` that breaks the timed path of the configuration's entry
underneath, for each fault in ``FAULTS``."""

import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench import harness, roofline

BENCH = json.loads((harness.REPO / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
#: where each configuration's small size and each entry's faults are found
TESTS = Path(__file__).resolve().parent
#: a step that returns its state unchanged; one answer altered where produced
FAULTS = ("unchanged", "altered")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _file(path: Path, what: str) -> Path:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}: add {what}")
    return path


def _small(workload, bench=BENCH, tests=TESTS):
    """The overrides that run ``workload``'s configuration at a size the
    plain versions run in seconds (``small/<config>.json``)."""
    config = next(w["config"] for w in bench["workloads"] if w["name"] == workload)
    path = _file(tests / "small" / f"{config}.json",
                 f"the small size of configuration {config!r}, e.g. {{\"cells\": [4, 2, 2]}}")
    return json.loads(path.read_text())


def _fault(cell, tests=TESTS):
    """The module ``faults/<entry>.py`` of ``cell``'s entry."""
    entry = cell.config["entry"]
    path = _file(tests / "faults" / f"{entry}.py",
                 f"install(monkeypatch, fault) for entry {entry!r}, faults {FAULTS}")
    spec = importlib.util.spec_from_file_location(f"port_bench_fault_{entry}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _needs_two_solves(cell, name):
    """Whether end-to-end metric ``name`` reads nothing from a window of one
    solve (a percentile of the solves)."""
    one = harness.Run(config=cell.config, traffic=cell.traffic, device_kind="cpu",
                      setup_s=1.0, build_s=1.0, window_s=1.0, solve_s=[1.0], units=[1])
    return cell.end_to_end[name][1](one) is None


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_resolves_by_name(workload):
    cell = harness.load_cell(workload)
    assert cell.config["name"] == cell.workload["config"]
    assert set(cell.limits) and all("limit" in v for v in cell.limits.values())
    names = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    assert set(cell.end_to_end) <= names and "setup_s" in cell.end_to_end
    assert len(cell.end_to_end) >= 2 and cell.per_layer


def _copy(tmp_path):
    """A copy of the benchmark's directory and a copy of BENCHMARK.json to
    extend, and every file of the directory as it was."""
    shutil.copytree(harness.ROOT, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "port_bench").rglob("*") if p.is_file()}
    return json.loads(json.dumps(BENCH)), before


def _add_workload(bench, like, name, **keys):
    """Appends workload ``name``, made like ``like`` with ``keys`` changed,
    to ``bench`` and to every metric list that names ``like``."""
    wl = next(w for w in bench["workloads"] if w["name"] == like)
    bench["workloads"].append({**wl, "name": name, **keys})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"].append(name)


def test_new_traffic_file_is_found_without_editing_a_file(tmp_path):
    """A later cell adds a traffic file, its limits and a BENCHMARK.json
    entry; the harness finds all of them by name and no file changes."""
    bench, before = _copy(tmp_path)
    base = harness.load_cell(WORKLOADS[0])
    name = f"{base.workload['config']}.{base.workload['traffic']}-five"
    _add_workload(bench, WORKLOADS[0], name, traffic=f"{base.workload['traffic']}-five",
                  why="the same traffic from five seeded inputs")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "port_bench" / "traffic" / f"{base.workload['traffic']}-five.json").write_text(
        json.dumps({**base.traffic, "inputs": {**base.traffic["inputs"], "count": 5}}))
    shutil.copy(harness.ROOT / "limits" / f"{WORKLOADS[0]}.json",
                tmp_path / "port_bench" / "limits" / f"{name}.json")
    cell = harness.load_cell(name, repo=tmp_path)
    assert cell.traffic["inputs"]["count"] == 5
    assert cell.entry.__name__ == base.entry.__name__
    assert set(cell.end_to_end) == set(base.end_to_end)
    assert set(cell.per_layer) == set(base.per_layer)
    for path, data in before.items():
        assert (tmp_path / path).read_bytes() == data


#: run in a copy of the repo's benchmark, with its own harness, roofline
#: and test helpers: the new cell's unit of work, a correct run at its
#: small size, and a fault found through its entry that makes it incorrect
_IN_COPY = """
import json, sys
import pytest
from port_bench import harness, roofline
sys.path.insert(0, str(harness.ROOT / "tests"))
import test_port_bench_harness as t
name = sys.argv[1]
cell = harness.load_cell(name)
out = {"unit_work": list(roofline.unit_work(cell.config, cell.traffic))}
r = harness.run_cell(name, 2 ** 31 + 13, 0.2, False, "cpu", overrides=t._small(name))
out["correct"] = r["correct"]
with pytest.MonkeyPatch.context() as mp:
    t._fault(cell).install(mp, "altered")
    out["broken_correct"] = harness.run_cell(name, 5, 0.2, False, "cpu",
                                             overrides=t._small(name))["correct"]
print(json.dumps(out))
"""


def test_new_configuration_is_found_without_editing_a_file(tmp_path):
    """A later configuration adds its configuration file, its operator's
    count, its small size, its limits and a BENCHMARK.json entry, and
    reuses an entry (and so its faults); the harness, the roofline and
    these tests find all of them by name and no file changes."""
    bench, before = _copy(tmp_path)
    base = harness.load_cell(WORKLOADS[0])
    config, operator = f"{base.workload['config']}-copy", f"{base.config['operator']}_copy"
    pb = tmp_path / "port_bench"
    spec = next(c for c in bench["configs"] if c["name"] == base.workload["config"])
    bench["configs"].append({**spec, "name": config, "file": f"port_bench/configs/{config}.json"})
    name = f"{config}.{base.workload['traffic']}"
    _add_workload(bench, WORKLOADS[0], name, config=config)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (pb / "configs" / f"{config}.json").write_text(
        json.dumps({**base.config, "name": config, "operator": operator}))
    shutil.copy(pb / "operators" / f"{base.config['operator']}.py",
                pb / "operators" / f"{operator}.py")
    shutil.copy(pb / "tests" / "small" / f"{base.workload['config']}.json",
                pb / "tests" / "small" / f"{config}.json")
    shutil.copy(pb / "limits" / f"{WORKLOADS[0]}.json", pb / "limits" / f"{name}.json")

    cell = harness.load_cell(name, repo=tmp_path)
    assert cell.config["operator"] == operator and cell.entry is base.entry
    assert set(cell.end_to_end) == set(base.end_to_end)
    assert set(cell.per_layer) == set(base.per_layer)
    assert _small(name, bench, pb / "tests") == _small(WORKLOADS[0])
    assert _fault(cell, pb / "tests").install
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(tmp_path), str(harness.REPO), os.environ.get("PYTHONPATH", "")])}
    p = subprocess.run([sys.executable, "-c", _IN_COPY, name], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got == {"unit_work": list(roofline.unit_work(base.config, base.traffic)),
                   "correct": True, "broken_correct": False}
    for path, data in before.items():
        assert (tmp_path / path).read_bytes() == data


def test_missing_files_name_the_file_to_add(tmp_path):
    bench = json.loads(json.dumps(BENCH))
    cell = harness.load_cell(WORKLOADS[0])
    with pytest.raises(FileNotFoundError, match=r"small/.*\.json: add the small size"):
        _small(WORKLOADS[0], bench, tmp_path)
    with pytest.raises(FileNotFoundError, match=r"faults/.*\.py: add install"):
        _fault(cell, tmp_path)


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
    cell = harness.load_cell(workload)
    want = set(cell.end_to_end)
    if r["attempted"] < 2:  # a percentile needs two solves; a busy CPU may give one
        want = {m for m in want if not _needs_two_solves(cell, m)}
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


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", WORKLOADS)
def test_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    _fault(harness.load_cell(workload)).install(monkeypatch, fault)
    r = harness.run_cell(workload, 3, 0.2, False, "cpu", overrides=_small(workload))
    assert not r["correct"] and r["failed"] >= 1
