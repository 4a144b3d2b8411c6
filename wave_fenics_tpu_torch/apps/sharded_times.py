"""The sharded structured box's solves on one CUDA card, for the package of
a given tree of the repository, so that two trees can be timed in turns
within one call (parent, new, new, parent).

Run it by path, not as a module, so that the package comes from ``--root``:

    python wave_fenics_tpu_torch/apps/sharded_times.py [--root DIR] [--steps 100]

The model is the planar3d case at 64x32x32 cells, p = 4, f32 (4,276,737
dofs), every block on the card, tile 48. For ``solve_step_n`` (kernel A),
``solve_lf_n`` (H), ``solve_lf2_n`` (I) and, where the tree has it,
``solve_step2_n`` (J) on (2,2,1) blocks and ``solve_n`` (B) on (2,1,1) it
reports, after a 2-step warm-up:

- ``ms_per_step``: the host clock around ``--steps`` steps, synchronized
  before and after;
- ``device_ms_per_step``: the device time of every kernel and copy the
  profiler records over one more such solve (``torch.profiler``), and
  ``idle_share`` = 1 - device / host time of that solve;
- ``exchange_ms_per_step`` (the value-halo paths): ``refresh`` of u and v,
  CUDA events over back-to-back calls, per step (half a call's on the
  2-step paths lf2 and step2).

Where the tree has ``parallel/sharded_general.py``, it also times the
imported-mesh paths: ``ShardedGeneralWave.solve_n`` RK4 and leapfrog on the
perturbed 64x32x32-cell box (``general_solve.build``, p = 4, f32, 4,276,737
dofs) on 4 RCB parts, the assembly ``auto``: the same ``ms_per_step``,
``device_ms_per_step`` and ``idle_share``, and ``assembly_ms_per_step``
from CUDA events around every ``_assemble`` inside the timed solve (the
packing, the collective and the adds), with ``one_device_ms_per_step`` of
``GeneralLinearWave.solve_n`` beside them.

It prints the card's name and power limit (nvidia-smi) and, last, one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the tree whose wave_fenics_tpu_torch package is timed")
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("sharded_times needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    import wave_fenics_tpu_torch
    from wave_fenics_tpu_torch.apps import planar3d_app
    from wave_fenics_tpu_torch.parallel.sharded_padded import ShardedPaddedWave
    from wave_fenics_tpu_torch.utils.timing import timeit

    if not Path(wave_fenics_tpu_torch.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"wave_fenics_tpu_torch was imported from "
                           f"{wave_fenics_tpu_torch.__file__}, not from {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    case, _ = planar3d_app.build((64, 32, 32), 4, "f32", None, "cuda")
    n = args.steps
    out = {"card": card, "root": str(root), "steps": n}
    paths = [("step", (2, 2, 1)), ("lf", (2, 2, 1)), ("lf2", (2, 2, 1)),
             ("n", (2, 1, 1))]
    if hasattr(ShardedPaddedWave, "step2_unavailable"):  # trees with sharded J
        paths.append(("step2", (2, 2, 1)))
    for kind, parts in paths:
        sw = ShardedPaddedWave(case.model, parts, tile_x=48)
        solve = {"n": sw.solve_n, "step": sw.solve_step_n, "lf": sw.solve_lf_n,
                 "lf2": sw.solve_lf2_n,
                 "step2": getattr(sw, "solve_step2_n", None)}[kind]
        solve(0.0, case.dt, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u, v = solve(0.0, case.dt, n)[:2]
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0) / n
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            solve(0.0, case.dt, n)
            torch.cuda.synchronize()
            prof_host_ms = 1e3 * (time.perf_counter() - t0) / n
        dev_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / n
        r = {"parts": list(parts), "ms_per_step": host_ms, "device_ms_per_step": dev_ms,
             "idle_share": 1.0 - dev_ms / prof_host_ms}
        if kind != "n":
            lay = sw.halo_layout(kind)
            per_call = 1e3 * timeit(lambda: (sw.refresh(u, lay), sw.refresh(v, lay)),
                                    reps=50)
            r["exchange_ms_per_step"] = per_call / (2 if kind in ("lf2", "step2") else 1)
        out[kind] = r
        print(f"{kind} {parts}: {host_ms:.4f} ms/step, device {dev_ms:.4f} ms/step "
              f"(idle {100 * r['idle_share']:.1f} %)"
              + (f", refresh {r['exchange_ms_per_step']:.4f} ms/step" if kind != "n"
                 else "") + f" ({root})")
        del sw, u, v
    if (root / "wave_fenics_tpu_torch" / "parallel" / "sharded_general.py").is_file():
        out.update(_general_times(n))
    print(card)
    print(json.dumps(out))


def _general_times(n: int) -> dict:
    """The imported-mesh sharded solves (RK4, leapfrog) on 4 parts against
    one device: the records of the module's docstring."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from wave_fenics_tpu_torch.benchmarks import general_solve
    from wave_fenics_tpu_torch.parallel.sharded_general import ShardedGeneralWave

    model, _ = general_solve.build((64, 32, 32), degree=4, dtype="f32")
    dt = 0.5 * general_solve.min_edge(model.mesh) / (model.c0 * 16)
    out = {}
    for integrator, dtx in (("rk4", dt), ("leapfrog", dt * general_solve.LEAPFROG_DT)):
        sw = ShardedGeneralWave(model, 4)
        sw.solve_n(0.0, dtx, 2, integrator=integrator)
        spans, inner = [], sw._assemble

        def assemble(b, inner=inner, spans=spans):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            b = inner(b)
            ev[1].record()
            spans.append(ev)
            return b

        sw._assemble = assemble
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sw.solve_n(0.0, dtx, n, integrator=integrator)
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0) / n
        asm_ms = sum(a.elapsed_time(b) for a, b in spans) / n
        del sw._assemble
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sw.solve_n(0.0, dtx, n, integrator=integrator)
            torch.cuda.synchronize()
            prof_host_ms = 1e3 * (time.perf_counter() - t0) / n
        dev_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / n
        model.solve_n(0.0, dtx, 2, integrator=integrator)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.solve_n(0.0, dtx, n, integrator=integrator)
        torch.cuda.synchronize()
        one_ms = 1e3 * (time.perf_counter() - t0) / n
        r = {"parts": 4, "exchange": sw.exchange_mode, "ms_per_step": host_ms,
             "device_ms_per_step": dev_ms, "idle_share": 1.0 - dev_ms / prof_host_ms,
             "assembly_ms_per_step": asm_ms, "assembly_share": asm_ms / host_ms,
             "one_device_ms_per_step": one_ms}
        out[f"general {integrator}"] = r
        print(f"general {integrator} (4 parts, {sw.exchange_mode}): {host_ms:.4f} ms/step, "
              f"device {dev_ms:.4f} ms/step (idle {100 * r['idle_share']:.1f} %), "
              f"assembly {asm_ms:.4f} ms/step ({100 * r['assembly_share']:.1f} %); one "
              f"device {one_ms:.4f} ms/step")
        del sw
    return out


if __name__ == "__main__":
    main()
