"""Where the RK4 step path's time goes on one CUDA card.

Builds the planar3d case as the app does (``planar3d_app.build``), warms up,
and runs ``PaddedLinearWave.solve_step_n`` twice:

- under ``torch.profiler``: per stage of kernel A
  (``csrc/wave_kernels.cu::rk4_stage_kernel<T, J>``) the launches and the
  device microseconds per launch, the bandwidth those times imply for the
  fields each stage has to move (a model of the traffic, not a count), and
  the device's busy share (device time of all kernels / wall time);
- without it: the host's enqueue time per step (until ``solve_step_n``
  returns, before the card has finished) and the synced time per step.

Run from the repository root on a machine with a CUDA card:

    python -m wave_fenics_tpu_torch.apps.profile_step [--cells 64 32 32]
           [--degree 4] [--dtype f32|f64] [--tile-x 48] [--steps 100]

It prints the card's name and power limit (nvidia-smi), one line per stage,
and last one JSON dict of every number.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import time

import torch

from ..utils.timing import sync
from . import planar3d_app

#: padded state fields each stage of kernel A reads or writes in full
#: (point-wise reads on the source/ABC rows only are not counted):
#: J=0 u0 -> kv0; J=1 u0, v0 -> kv1; J=2 u0, v0, kv0 -> kv2;
#: J=3 u0, v0, kv0, kv1, kv2 -> u1, v1
STAGE_FIELDS = {0: 2, 1: 3, 2: 4, 3: 7}

_STAGE_RE = re.compile(r"rk4_stage_kernel<[^,<>]+,\s*(\d)>")


def card_line() -> str:
    """``name, power limit`` of card 0 as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()


def profile(cells=(64, 32, 32), degree=4, dtype="f32", tile_x=None,
            steps=100, warmup=5) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    case, pm = planar3d_app.build(cells, degree, dtype, tile_x, "cuda")
    dev = pm.base.device
    field_bytes = math.prod(pm.layout.padded_shape) \
        * torch.finfo(pm.base.dtype).bits // 8
    pm.solve_step_n(case.t0, case.dt, warmup)
    sync(dev)

    # host enqueue and synced step time, no profiler
    t0 = time.perf_counter()
    pm.solve_step_n(case.t0, case.dt, steps)
    t1 = time.perf_counter()
    sync(dev)
    t2 = time.perf_counter()

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        sync(dev)
        w0 = time.perf_counter()
        pm.solve_step_n(case.t0, case.dt, steps)
        sync(dev)
        wall_us = (time.perf_counter() - w0) * 1e6

    busy_us = 0.0
    stage_us = {j: 0.0 for j in STAGE_FIELDS}
    stage_n = {j: 0 for j in STAGE_FIELDS}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        busy_us += us
        m = _STAGE_RE.search(e.name)
        if m:
            stage_us[int(m.group(1))] += us
            stage_n[int(m.group(1))] += 1
    if busy_us == 0.0 or any(stage_n[j] != steps for j in STAGE_FIELDS):
        raise RuntimeError(
            f"the profiler saw {busy_us} us of device time and stage launches "
            f"{stage_n} (want {steps} each): it does not trace this card; "
            "time with CUDA events instead (utils.timing.timeit)")

    stages = []
    for j, nf in STAGE_FIELDS.items():
        us = stage_us[j] / stage_n[j]
        stages.append({"stage": j, "launches": stage_n[j], "us_per_launch": us,
                       "fields": nf,
                       "model_gbps": nf * field_bytes / (us * 1e-6) / 1e9})
    step_us = sum(s["us_per_launch"] for s in stages)
    return {
        "card": card_line(),
        "cells": list(cells), "degree": degree, "dtype": dtype,
        "ndofs": int(case.model.ops.ndofs),
        "padded_shape": list(pm.layout.padded_shape),
        "field_bytes": field_bytes,
        "steps": steps,
        "stages": stages,
        "kernel_us_per_step": step_us,
        "model_gbps_per_step": sum(STAGE_FIELDS.values()) * field_bytes
        / (step_us * 1e-6) / 1e9,
        "profiled_wall_ms_per_step": wall_us / steps / 1e3,
        "device_busy_share": busy_us / wall_us,
        "enqueue_ms_per_step": (t1 - t0) / steps * 1e3,
        "synced_ms_per_step": (t2 - t0) / steps * 1e3,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, nargs=3, default=(64, 32, 32))
    ap.add_argument("--degree", type=int, default=4)
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f32")
    ap.add_argument("--tile-x", type=int, default=None)
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args(argv)
    out = profile(args.cells, args.degree, args.dtype, args.tile_x, args.steps)
    print(out["card"])
    for s in out["stages"]:
        print(f"stage J={s['stage']}: {s['us_per_launch']:.2f} us/launch "
              f"x {s['launches']}, {s['fields']} fields, "
              f"{s['model_gbps']:.1f} GB/s (model)")
    print(f"kernel {out['kernel_us_per_step']:.1f} us/step; busy share "
          f"{out['device_busy_share']:.4f} under the profiler; enqueue "
          f"{out['enqueue_ms_per_step']:.4f} ms/step, synced "
          f"{out['synced_ms_per_step']:.4f} ms/step without it")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
