"""The harness: finds a cell's files by name, builds the cell, runs the
measured window, judges its answers against the plain reference and
reads the cell's metrics.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own under this directory, found by the name that
``BENCHMARK.json`` gives it:

- ``configs/<config>.json`` (the file named under ``configs``): the sizes;
  its ``entry`` names the module of ``entries/`` that drives the port, its
  ``reference`` the module of ``reference/`` that checks it, its
  ``operator`` the file of ``operators/`` that counts an apply's
  operations (``roofline.py``); ``tests/small/<config>.json`` is its size
  in the CPU tests, ``tests/faults/<entry>.py`` the faults planted under
  its entry there;
- ``traffic/<traffic>.json``: the scheme the entry runs, the inputs
  (``inputs.py``), the solves traced, the answers sampled and the roofline
  unit (``roofline.py``);
- ``limits/<workload>.json``: the limit of each number compared, with the
  readings it was set from;
- ``metrics/<metric>.py``: a reader ``read(run)`` of one metric, which
  returns None where it finds nothing to read.

A window is a closed loop of whole solves, back to back: the next input
in turn, the port's solve, a synchronise. It ends with the first solve
that completes after ``seconds``; its length is the time to that
completion. A uniform sample of the window's answers, drawn from the
seed, is kept and judged once the window has closed.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import random
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch
import torch.profiler

from port_bench import inputs as input_gen
from port_bench import roofline, trace as trace_mod

__all__ = ["ROOT", "REPO", "Cell", "Run", "load_cell", "run_cell", "FORBIDDEN"]

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
#: top-level module names that may not be loaded in a run's process
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "wave_fenics_tpu"})
#: index of the first traced solve (the window's first solve is not traced)
TRACE_FROM = 1


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    entry: object
    reference: object
    #: metric name -> (BENCHMARK.json entry, reader function)
    end_to_end: dict
    per_layer: dict


def _reader(path: Path):
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, repo: Path = REPO) -> Cell:
    """The cell ``workload`` of ``repo``'s ``BENCHMARK.json``, each of its
    files found by name under ``repo/port_bench``."""
    root = Path(repo) / "port_bench"
    bench = _json(Path(repo) / "BENCHMARK.json")
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise ValueError(f"no workload {workload!r} in BENCHMARK.json: "
                         f"{[w['name'] for w in bench['workloads']]}")
    cfg = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = _json(Path(repo) / cfg["file"])

    def readers(kind):
        return {m["name"]: (m, _reader(root / "metrics" / f"{m['name']}.py"))
                for m in bench[kind] if _applies(m, workload)}

    return Cell(
        workload=wl, config=config,
        traffic=_json(root / "traffic" / f"{wl['traffic']}.json"),
        limits=_json(root / "limits" / f"{workload}.json"),
        entry=importlib.import_module(f"port_bench.entries.{config['entry']}"),
        reference=importlib.import_module(f"port_bench.reference.{config['reference']}"),
        end_to_end=readers("end_to_end"), per_layer=readers("per_layer"))


@dataclass
class Run:
    """What a metric reader reads."""

    config: dict
    traffic: dict
    device_kind: str
    setup_s: float
    build_s: float
    window_s: float
    #: wall seconds of each solve of the window, start to synchronise
    solve_s: list = field(default_factory=list)
    #: units of work (steps or iterations) of each solve
    units: list = field(default_factory=list)
    trace: trace_mod.Trace | None = None

    @property
    def per(self) -> str:
        return self.traffic["roofline"]["per"]

    @property
    def ndofs(self) -> int:
        return roofline.ndofs(self.config["cells"], self.config["degree"])


class Reservoir:
    """Slots for a uniform sample of ``size`` items of a stream, drawn from
    ``seed`` (reservoir sampling): ``place`` says which slot the next item
    takes, or None."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng, self.seen = size, random.Random(seed), 0

    def place(self) -> int | None:
        j = self.seen if self.seen < self.size else self.rng.randrange(self.seen + 1)
        self.seen += 1
        return j if j < self.size else None


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _finite(x: float) -> float | None:
    return x if math.isfinite(x) else None


def run_cell(workload: str, seed: int, seconds: float, trace: bool = False,
             device="cuda", overrides: dict | None = None,
             t_process: float | None = None) -> dict:
    """One run of a cell: the result line's object, ``checks`` last.

    ``overrides`` replaces keys of the configuration (the tests' small
    sizes; the control's lower precision). ``t_process`` is the host clock
    at the process's start, from which ``setup_s`` counts."""
    t_process = time.perf_counter() if t_process is None else t_process
    marks = [("start", time.perf_counter())]
    cell = load_cell(workload)
    config = {**cell.config, **(overrides or {})}
    traffic = cell.traffic
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- set-up: inputs from the seed, the port's model, one warm-up solve
    raw = input_gen.make(config, traffic["inputs"], seed, dev)
    _sync(dev)
    marks.append(("inputs", time.perf_counter()))
    entry = cell.entry.Entry(config, traffic, dev)
    entry.load(raw)
    marks.append(("model", time.perf_counter()))
    # the sampled answers are copied into slots allocated before the
    # warm-up, so that the window allocates nothing the warm-up did not
    sample = Reservoir(traffic["check_sample"], seed)
    slots = [[torch.empty_like(t) for t in entry.inputs[0]] for _ in range(sample.size)]
    kept = {}
    out, _ = entry.solve(*entry.inputs[0])
    del out
    _sync(dev)
    t_start = time.perf_counter()
    marks.append(("warm-up solve", t_start))
    setup_s = t_start - t_process

    # -- the window
    n_traced = traffic["trace_solves"] if trace else 0
    prof, events = None, []
    solve_s, units = [], []
    rf = torch.profiler.record_function
    i = 0
    while True:
        if n_traced and i == TRACE_FROM:
            # one solve of the profiler's own warm-up, then the traced ones
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA],
                schedule=torch.profiler.schedule(wait=0, warmup=1, active=n_traced, repeat=1),
                on_trace_ready=lambda p: events.append(p.events()))
            prof.start()
        with rf("port_bench.prep"):
            inp = entry.inputs[i % len(entry.inputs)]
        t0 = time.perf_counter()
        with rf("port_bench.solve"):
            out, work = entry.solve(*inp)
        with rf("port_bench.sync"):
            _sync(dev)
        t1 = time.perf_counter()
        solve_s.append(t1 - t0)
        units.append(work)
        j = sample.place()
        if j is not None:
            for dst, src in zip(slots[j], out[0]):
                dst.copy_(src)
            kept[j] = (i, out[1])
        del out
        i += 1
        if prof is not None:
            prof.step()
            if i == TRACE_FROM + 1 + n_traced:
                prof.stop()
                prof = None
        if t1 - t_start >= seconds and (not n_traced or i > TRACE_FROM + n_traced):
            break
    window_s = t1 - t_start

    # -- after the window: the peak, the answers, the program's state freed
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    answers = [(idx, entry.answer((slots[j], extra))) for j, (idx, extra) in kept.items()]
    build_s, path = entry.build_s, entry.path
    entry.release()
    del entry, inp, slots
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    tr = None
    if events:
        first = TRACE_FROM + 1
        tr = trace_mod.summarize(events[0], sum(units[first:first + n_traced]))

    # -- correct: each sampled answer against the plain reference
    t_ref = time.perf_counter()
    ref = cell.reference.Reference(config, traffic, dev)
    expected, worst, failed = {}, {}, 0
    for idx, ans in answers:
        k = idx % len(raw)
        if k not in expected:
            expected[k] = ref.answer(raw[k])
        got = cell.reference.compare(ans, expected[k])
        bad = False
        for name, value in got.items():
            v = value if math.isfinite(value) else math.inf
            worst[name] = max(worst.get(name, -math.inf), v)
            bad |= not v <= cell.limits[name]["limit"]
        failed += bad
    _sync(dev)
    t_ref = time.perf_counter() - t_ref
    checks = {name: {"value": _finite(worst[name]), "limit": cell.limits[name]["limit"]}
              for name in worst}
    correct = bool(answers) and failed == 0

    run = Run(config=config, traffic=traffic, device_kind=kind, setup_s=setup_s,
              build_s=build_s, window_s=window_s, solve_s=solve_s, units=units, trace=tr)
    readers = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for name, (spec, read) in readers.items():
        value = read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": spec["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": kind,
              "count": cell.workload["chips"], "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": i, "failed": failed,
              "metrics": metrics, "device": device}
    if tr is not None:
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    phases = ", ".join(f"{name} {t - marks[k][1]:.3f} s"
                       for k, (name, t) in enumerate(marks[1:]))
    print(f"cell {workload}: {path}; set-up {setup_s:.3f} s (before the harness "
          f"{marks[0][1] - t_process:.3f} s, {phases}); {i} solves, {sum(units)} units in "
          f"{window_s:.4f} s; sample {sorted(idx for idx, _ in answers)}; "
          f"{len(expected)} reference answers in {t_ref:.2f} s", file=sys.stderr)
    result["checks"] = checks
    return result
