"""Where a solver path's time goes on one CUDA card.

Builds the planar3d case as the app does (``planar3d_app.build``), takes the
solver path the app would take (``planar3d_app.solver_path``: RK4 through
kernel A, C, D or, with ``--two-step``, J, or RK4 on ``f1`` through kernel
E at p > 8; leapfrog through kernel I or H, or on ``force`` through kernel
E at p > 8), warms up, and runs it twice:

- under ``torch.profiler``: per kernel instance (each stage of kernels A
  and C, which kernel J also launches, J's step-boundary kernel, kernel D,
  each phase of kernels H and I, kernel E) the launches and the
  device microseconds per launch, the bandwidth those times imply for the
  state fields each launch has to move (a model of the traffic, not a
  count), the device's busy share (the union of the device's intervals /
  wall time) and, on the paths with step spans (A, C, H, I), the host's
  issue time a step: its ``wave.rk4.step``, ``wave.lf2.call`` and
  ``wave.lf.step`` spans less the time it waited on a full launch queue;
- without it: the host's enqueue time per step (until the solve returns,
  before the card has finished; once the launch queue fills, the device's
  pace) and the synced time per step.

With ``--bp1`` it profiles one BP1 CG solve instead (``cg_bench``'s
problem on a unit box of ``--cells``, kmax 50, rtol 1e-4, the reference's
settings): the device time of kernel G (the matvec, one launch per
iteration and one for r0), the device time of every other kernel (the
vector operations: axpys, dots, the scalar updates), and the rest of the
wall time, which is the host: enqueueing, and the one scalar read per
iteration that CG's stopping test waits for. CG's spans split the host's
time an iteration into its wait (``wave.cg.stop_test``) and its issue
(the rest of ``wave.cg.iter``).

With ``--general`` it profiles RK4 steps of the explicit-dofmap model
(``general_solve``'s perturbed box of ``--cells``, 4,276,737 dofs at the
default 64x32x32 cells and p=4): kernel K's launches (per apply, the pass
that sets y to 0 and one launch per colour, four applies per step), the
plain-torch vector algebra of the RK4 stages, and the host's share of the
wall time. It raises unless kernel K ran four applies per step, each with
one zero launch and one launch per colour. The colour launches overlap
(programmatic dependent launch), so their summed device times count the
overlap twice; ``--general --ablate`` times an apply on CUDA events.

Run from the repository root on a machine with a CUDA card:

    python -m wave_fenics_tpu_torch.apps.profile_step [--cells 64 32 32]
           [--degree 4] [--dtype f32|f64|bf16] [--tile-x 48] [--steps 100]
           [--integrator rk4|leapfrog] [--full-tableau] [--two-step]
    python -m wave_fenics_tpu_torch.apps.profile_step --degree 10 \
           --cells 26 13 13 [--integrator leapfrog]    # kernel E
    python -m wave_fenics_tpu_torch.apps.profile_step --bp1 --cells 64 64 64
    python -m wave_fenics_tpu_torch.apps.profile_step --general [--steps 20]
    python -m wave_fenics_tpu_torch.apps.profile_step --general --ablate     # kernel K
    python -m wave_fenics_tpu_torch.apps.profile_step --ablate --integrator leapfrog \
           [--degree 8 --cells 32 16 16]   # kernel I (H at p = 8)
    python -m wave_fenics_tpu_torch.apps.profile_step --sweep-tiling [--full-tableau]
    python -m wave_fenics_tpu_torch.apps.profile_step --ablate [--full-tableau]
    python -m wave_fenics_tpu_torch.apps.profile_step --ablate --degree 8 \
           --cells 32 16 16          # kernel D (the path's RK4 stage kernel)
    python -m wave_fenics_tpu_torch.apps.profile_step --ablate --degree 10 \
           --cells 26 13 13          # kernel E
    python -m wave_fenics_tpu_torch.apps.profile_step --ablate --two-step   # J's boundary
    python -m wave_fenics_tpu_torch.apps.profile_step --ablate --bp1 --cells 64 64 64  # G
    python -m wave_fenics_tpu_torch.apps.profile_step --ablate --stiffness --cells 64 64 64  # F
    python -m wave_fenics_tpu_torch.apps.profile_step --ablate --flat       # B, P1 layout

With ``--sweep-tiling`` it times each stage launch of kernel A (or C)
with its padding blocks where ``ops/rk4step.py::stage_geometry`` puts
them and on the grid's other end; with ``--ablate``
it times the kernel of the path's RK4 (each stage of A or C, or one launch
of D or E), or with ``--integrator leapfrog`` each phase of I (or H), as
built and with the stencil replaced by the point value (a patched copy of
``csrc/``, built under ``_build/``; A, C, D, E, H and I also without each
of the parts ``ABLATIONS`` takes out; H and I also with their padding
layer on the grid's other end), beside one field copy; with ``--two-step
--ablate`` kernel J's step-boundary launch, with ``--bp1 --ablate`` kernel
G's apply on the BP1 layout of ``--cells`` (its z and y contractions
replaced by the window's point value), with ``--stiffness --ablate`` kernel
F's apply on the unpadded grid of a unit box of ``--cells`` (its y and z
taps replaced by the window's point value), with ``--flat --ablate`` kernel
B's apply on the planar3d layout of ``--cells`` (also with its padding
layer on the grid's other end), each as built and without each part
``ABLATIONS`` takes out of it; with ``--general --ablate``, kernel K's
stiffness apply as built, without each part ``ABLATIONS`` takes out of it,
and with all cells in one launch.

It prints the card's name and power limit (nvidia-smi), one line per kernel
instance, and last one JSON dict of every number.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import re
import shutil
import subprocess
import time

import numpy as np
import torch

from ..benchmarks import general_solve
from ..benchmarks.common import DTYPES
from ..convert import tables_from_numpy
from ..core.mesh import box_mesh
from ..ops import _cuda, general, lfstep, rk4step, rk42step, wave
from ..ops.general import general_apply_cuda
from ..ops.mass import bp1_setup, mass_apply, mass_launch_args
from ..ops.operators import StructuredOperators
from ..ops.stiffness import GridStiffnessTables, stiffness_grid_tables, stiffness_launch_args
from ..solvers.cg import cg
from ..utils.profiling import BLOCKED, device_busy_us, host_span_us
from ..utils.timing import sync, timeit
from . import planar3d_app

#: (pattern of the demangled kernel name, its label, the padded state
#: fields it reads or writes in full; point-wise reads on the source/ABC
#: rows only are not counted). Kernels A/C stage J (rk4_tiled_kernel<T, P,
#: J>, which kernel J also launches): J=0 u0 -> kv0; J=1 u0,
#: v0 -> kv1; J=2 u0, v0, kv0 -> kv2; J=3 u0, v0, kv0, kv1, kv2 -> u1, v1.
#: Kernel J's boundary: u0, v0, kv0, kv1, kv2 -> u1, v1, kv0'. D: u0, ku,
#: v0, kv, ua, va -> vn, kv', ua', va'. H/I: OPEN u0, v0 -> u1, v+; MID u1,
#: v+ -> u2, v+'; CLOSE u1, v+ -> v1. E: x -> y.
KERNELS = [
    (r"rk4_tiled_kernel<[^,<>]+,\s*\d+,\s*0>", "rk4 stage J=0", 2),
    (r"rk4_tiled_kernel<[^,<>]+,\s*\d+,\s*1>", "rk4 stage J=1", 3),
    (r"rk4_tiled_kernel<[^,<>]+,\s*\d+,\s*2>", "rk4 stage J=2", 4),
    (r"rk4_tiled_kernel<[^,<>]+,\s*\d+,\s*3>", "rk4 stage J=3", 7),
    (r"rk42_boundary_tiled_kernel<", "rk42 boundary (J)", 8),
    (r"rk_stage_tiled_kernel<", "rk stage (D)", 10),
    (r"lf_phase_tiled_kernel<[^,<>]+,\s*\d+,\s*0>", "lf OPEN", 4),
    (r"lf_phase_tiled_kernel<[^,<>]+,\s*\d+,\s*1>", "lf MID", 4),
    (r"lf_phase_tiled_kernel<[^,<>]+,\s*\d+,\s*2>", "lf CLOSE", 3),
    (r"apply_flat_tiled_kernel<", "apply_flat (B)", 2),
    (r"apply_slab_tiled_kernel<", "apply_slab (E)", 2),
]
_KERNEL_RES = [(re.compile(pat), label, fields) for pat, label, fields in KERNELS]
#: the step paths' spans (utils/profiling.py) and the steps each covers
STEP_SPANS = {"wave.rk4.step": 1, "wave.lf2.call": 2, "wave.lf.step": 1}


def expected_launches(pm, integrator: str, steps: int,
                      two_step: bool = False) -> dict[str, int]:
    """Launches per kernel label that ``steps`` steps of the path
    ``planar3d_app.solver_path(pm, integrator, two_step)`` make, decided by
    the same applicability checks in the same order."""
    stiffness = "apply_slab (E)" if pm.kernel == "3d" else "apply_flat (B)"
    if two_step:  # J: C's stages 0, 1, 2, boundary, 1, 2, 3; odd step: A/C
        half, odd = divmod(steps, 2)
        return {"rk4 stage J=0": half + odd, "rk4 stage J=1": 2 * half + odd,
                "rk4 stage J=2": 2 * half + odd, "rk4 stage J=3": half + odd,
                "rk42 boundary (J)": half}
    if integrator == "leapfrog":
        if pm.lf2_unavailable is None:  # I; an odd last step through H
            half, odd = divmod(steps, 2)
            return {"lf OPEN": half + odd, "lf MID": half, "lf CLOSE": half + odd}
        if pm.lf_unavailable is None:  # H
            return {"lf OPEN": steps, "lf CLOSE": steps}
        return {stiffness: steps + 1}  # one force per step, and F(t0)
    if pm.step_unavailable is None:  # A or C
        return {f"rk4 stage J={j}": steps for j in range(4)}
    if pm.stage_unavailable is None:  # D
        return {"rk stage (D)": 4 * steps}
    return {stiffness: 4 * steps}  # RK4 on f1


def card_line() -> str:
    """``name, power limit`` of card 0 as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()


def profile(cells=(64, 32, 32), degree=4, dtype="f32", tile_x=None,
            steps=100, warmup=6, integrator="rk4", lean=True,
            two_step=False) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    case, pm = planar3d_app.build(cells, degree, dtype, tile_x, "cuda", lean)
    dt = case.dt * (0.71 if integrator == "leapfrog" else 1.0)
    path, solve, _ = planar3d_app.solver_path(pm, integrator, two_step)
    dev = pm.base.device
    field_bytes = math.prod(pm.layout.padded_shape) \
        * torch.finfo(pm.base.dtype).bits // 8
    solve(case.t0, dt, warmup)
    sync(dev)

    # host enqueue and synced step time, no profiler
    t0 = time.perf_counter()
    solve(case.t0, dt, steps)
    t1 = time.perf_counter()
    sync(dev)
    t2 = time.perf_counter()

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        sync(dev)
        w0 = time.perf_counter()
        solve(case.t0, dt, steps)
        sync(dev)
        wall_us = (time.perf_counter() - w0) * 1e6

    events = prof.events()
    busy_us = device_busy_us(events)
    device_us = 0.0
    us = {label: 0.0 for _, label, _ in _KERNEL_RES}
    n = {label: 0 for _, label, _ in _KERNEL_RES}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        device_us += e.time_range.elapsed_us()
        for rx, label, _ in _KERNEL_RES:
            if rx.search(e.name):
                us[label] += e.time_range.elapsed_us()
                n[label] += 1
                break
    if busy_us == 0.0 or not any(n.values()):
        raise RuntimeError(
            f"the profiler saw {busy_us} us of device time and kernel launches "
            f"{n}: it does not trace this card; time with CUDA events instead "
            "(utils.timing.timeit)")
    seen = {label: k for label, k in n.items() if k}
    want = expected_launches(pm, integrator, steps, two_step)
    if seen != want:
        raise RuntimeError(
            f"{path}: the profiler saw kernel launches {seen}, the path makes "
            f"{want} in {steps} steps")

    kernels = []
    for _, label, nf in _KERNEL_RES:
        if not n[label]:
            continue
        per = us[label] / n[label]
        kernels.append({"kernel": label, "launches": n[label],
                        "us_per_launch": per, "fields": nf,
                        "model_gbps": nf * field_bytes / (per * 1e-6) / 1e9})
    kernel_us = sum(k["us_per_launch"] * k["launches"] for k in kernels)
    moved = sum(k["fields"] * k["launches"] for k in kernels) * field_bytes
    spans = {name: host_span_us(events, (name,), (BLOCKED,)) for name in STEP_SPANS}
    spanned = sum(STEP_SPANS[name] * k for name, (k, _) in spans.items())
    return {
        "card": card_line(),
        "cells": list(cells), "degree": degree, "dtype": dtype,
        "integrator": integrator, "lean": lean, "two_step": two_step,
        "solver_path": path,
        "ndofs": int(case.model.ops.ndofs),
        "padded_shape": list(pm.layout.padded_shape),
        "field_bytes": field_bytes,
        "steps": steps,
        "kernels": kernels,
        "kernel_us_per_step": kernel_us / steps,
        # the plain-torch vector kernels of the f1/force paths (E, B)
        "other_device_us_per_step": (device_us - kernel_us) / steps,
        "model_gbps": moved / (kernel_us * 1e-6) / 1e9,
        "profiled_wall_ms_per_step": wall_us / steps / 1e3,
        "device_busy_share": busy_us / wall_us,
        "step_spans": {name: k for name, (k, _) in spans.items()},
        # None on the paths whose steps the spans do not cover (D, E, J)
        "host_issue_ms_per_step": (sum(t for _, t in spans.values()) / 1e3 / steps
                                   if spanned == steps else None),
        "enqueue_ms_per_step": (t1 - t0) / steps * 1e3,
        "synced_ms_per_step": (t2 - t0) / steps * 1e3,
    }


#: the ablations of --ablate: patched copies of the sources, each a set of
#: (file: the lines it replaces exactly once, the replacement). "point
#: value" replaces the lines that apply the stencil of kernels A and C
#: (rk4_tiled.cu), B (flat_tiled.cu), D (rk_stage_tiled.cu), E
#: (slab_tiled.cu), H/I (lf_tiled.cu) and J's boundary (rk42_tiled.cu) by
#: the point value (the same fetches, stage inputs and stores, no taps),
#: kernel G's z and y contractions (mass_tiled.cu) by the window's point
#: value (no z-contracted plane; the x contraction stays), and kernel F's
#: y and z taps (stiffness_tiled.cu) by the window's point value (the x
#: taps and the line products stay); the others take one part out of A/C,
#: B, D, E, G, H/I or J's boundary: its padding pass (the padding blocks
#: return at once), A's stage-3, D's or J's point-wise loads (u0, v0, kv0,
#: kv1, kv2; v0, kv, ua, va; v0, kv0, kv1, kv2: a value from the index
#: instead), or the stage inputs D and J
#: form (u0's window read in their place); "padding layer last" moves
#: B's padding layer to the grid's last layer.
_A_POINT_LOADS = """        pn[0] = widen(a.u0[nidx]);
        pn[1] = widen(a.v0[nidx]);
        pn[2] = widen(a.kv0[nidx]);
        pn[3] = widen(a.kv1[nidx]);
        pn[4] = widen(a.kv2[nidx]);"""
_D_POINT_LOADS = """      pn[0] = widen(a.v0[nidx]);
      pn[1] = widen(a.kv[nidx]);
      pn[2] = widen(a.ua[nidx]);
      pn[3] = widen(a.va[nidx]);"""
_J_POINT_LOADS = """      pn[0] = widen(a.v0[nidx]);
      pn[1] = widen(a.kv0[nidx]);
      pn[2] = widen(a.kv1[nidx]);
      pn[3] = widen(a.kv2[nidx]);"""
_J_STENCILS = """    A kv3 = x_taps<A, P>(s, q3, g) * tab.fx + yz3 * sxg;
    if (g == a.src_x) kv3 += (a.c0sq * a.g) * w1;
    if (g == a.abc_x) kv3 += (a.mc0 * w2) * (pt[0] + dt * pt[3]);
    const A accv = ((b0 * pt[1] + b1 * pt[2]) + b1 * pt[3]) + b0 * kv3;
    const T v1 = narrow<T>(pt[0] + dt * accv);
    A kv = x_taps<A, P>(s, q1, g) * tab.fx + yz1 * sxg;"""
_J_FORM = """    for (int e = (int)threadIdx.x; e < npt; e += nt) {
      const int r = e / WF;
      const int j = r * W + w.oz + (e - r * WF);
      const A u0 = widen(sl[j]);
      const A v0 = widen(sl[box + j]);
      const A k0 = widen(sl[2 * box + j]);
      const A k1 = widen(sl[3 * box + j]);
      const A k2 = widen(sl[4 * box + j]);
      f3[j] = narrow<T>(u0 + dt * (v0 + hdt * k1));  // bf16 rounds un3, u1
      const A vn1 = v0 + hdt * k0;
      const A vn2 = v0 + hdt * k1;
      const A vn3 = v0 + dt * k2;
      f1[j] = narrow<T>(u0 + dt * (((b0 * v0 + b1 * vn1) + b1 * vn2) + b0 * vn3));
    }"""
_G_ZY = """    for (int r = c.ly; r < nrow; r += t.ty) zb[r * tz + c.lz] = band<A, P>(cz, xb + r * W, 1);
    __syncthreads();  // the z-contracted plane gi is complete, and every
                      // thread is past plane gi - 1: refill its slot
    if (threadIdx.x == 0 && i + kRing - 1 < iters) {
      ring.fetch(i + kRing - 1, &xmap, nullptr, zs, ys, gi + kRing - 1);
    }
    if (!c.active) continue;
    const A v = band<A, P>(cy, zb + c.ly * tz + c.lz, tz);  // y at the column"""
_F_YZ = """        A acc = A(0);
#pragma unroll
        for (int k = 0; k < K; ++k) acc += cy[r][k] * v[k + r];
        ty[r] = acc * (lx * lz);
        tz[r] = axis_taps<A, T, P>(cz, ctr + r * W, 1) * (lx * ly[r]);"""
ABLATIONS = {
    "point value": {
        "rk4_tiled.cu": ("A kv = x_taps<A, P>(s, q, g) * tab.fx + yz * widen(__ldg(&s.sx[g]));",
                         "A kv = q[P];"),
        "rk_stage_tiled.cu": ("A kv = tx * tab.fx + yz * widen(__ldg(&s.sx[g]));",
                              "A kv = q[P];"),
        "slab_tiled.cu": ("y[(long long)g * F + c.f] = narrow<T>((tx * lyz + ay) + az);",
                          "y[(long long)g * F + c.f] = narrow<T>(q[P]);"),
        "lf_tiled.cu": ("A force = tx * tab.fx + yz * widen(__ldg(&s.sx[g]));",
                        "A force = q[P];"),
        "rk42_tiled.cu": (_J_STENCILS, _J_STENCILS.replace(
            "x_taps<A, P>(s, q3, g) * tab.fx + yz3 * sxg", "q3[P]").replace(
            "x_taps<A, P>(s, q1, g) * tab.fx + yz1 * sxg", "q1[P]")),
        "mass_tiled.cu": (_G_ZY, "\n".join(_G_ZY.splitlines()[1:-1])
                          + "\n    const A v = widen(xb[(c.ly + P) * W + P]);"),
        "flat_tiled.cu": ("x_taps<A, P>(s, q, g) * tab.fx + yz * widen(__ldg(&s.sx[g]));",
                          "q[P];"),
        "stiffness_tiled.cu": (_F_YZ, "        ty[r] = v[P + r] * (lx * lz);\n"
                               "        tz[r] = v[P + r] * (lx * ly[r]);"),
    },
    "no padding pass": {
        "rk4_tiled.cu": ("    zero_padding<T>(s, t, (int)pb, (int)npb,",
                         "    if (false) zero_padding<T>(s, t, (int)pb, (int)npb,"),
        "rk_stage_tiled.cu": ("    for_each_padding<8>(s, t, pb, npb,",
                              "    if (false) for_each_padding<8>(s, t, pb, npb,"),
        "slab_tiled.cu": ("    for_each_padding<1>(s, t, pb, npb,",
                          "    if (false) for_each_padding<1>(s, t, pb, npb,"),
        "lf_tiled.cu": ("    for_each_padding<1>(s, t, pb, npb,",
                        "    if (false) for_each_padding<1>(s, t, pb, npb,"),
        "rk42_tiled.cu": ("    for_each_padding<1>(s, t, pb, npb,",
                          "    if (false) for_each_padding<1>(s, t, pb, npb,"),
        "mass_tiled.cu": ("    for_each_padding<1>(s, t, pb, npb,",
                          "    if (false) for_each_padding<1>(s, t, pb, npb,"),
        "flat_tiled.cu": ("    for_each_padding<1>(s, t, pb, npb,",
                          "    if (false) for_each_padding<1>(s, t, pb, npb,"),
    },
    # kernel F without its x taps (the point value in their place), and
    # without the copies of the planes after the first kPipe - 1 (the taps
    # read stale planes)
    "F no x taps": {
        "stiffness_tiled.cu": ("(tx[r] * (ly[r] * lz) + ay[r]) + az[r])",
                               "(q[r][P] * (ly[r] * lz) + ay[r]) + az[r])"),
    },
    "F no plane copies": {
        "stiffness_tiled.cu": ("if (ip < iters) w.fetch(", "if (false) w.fetch("),
    },
    "padding layer last": {
        "flat_tiled.cu": ("constexpr bool kPaddingFirst = true;",
                          "constexpr bool kPaddingFirst = false;"),
    },
    "no point-wise loads": {
        "rk4_tiled.cu": (_A_POINT_LOADS,
                         "        pn[0] = pn[1] = pn[2] = pn[3] = pn[4] = A(nidx & 1);"),
        "rk_stage_tiled.cu": (_D_POINT_LOADS,
                              "      pn[0] = pn[1] = pn[2] = pn[3] = A(nidx & 1);"),
        "rk42_tiled.cu": (_J_POINT_LOADS,
                          "      pn[0] = pn[1] = pn[2] = pn[3] = A(nidx & 1);"),
    },
    "u0 as the stage input": {
        "rk_stage_tiled.cu": ("for (int e = (int)threadIdx.x; e < npt; e += nt) {\n"
                              "      un[e] = narrow<T>(widen(ub[e]) + ca * widen(kb[e]));",
                              "un = const_cast<T*>(ub);\n    {"),
        "rk42_tiled.cu": (_J_FORM, "    f3 = const_cast<T*>(sl);\n    f1 = f3;"),
    },
    # the TMA kernels' window pitch (stencil_tiled.cuh::tma_window) cut to
    # the tile and its halo rounded up to 16 bytes, instead of the tile
    # width plus a multiple of 32 (fewer bytes a plane from L2; bank
    # conflicts where a warp spans two window rows)
    "tight window pitch": {
        "stencil_tiled.cuh": ("  const int W = t.tz + (oz + 2 * P + 31) / 32 * 32;",
                              "  const int W = (oz + t.tz + 2 * P + A - 1) / A * A;"),
    },
    # kernel K's collocated stiffness (general_kernels.cu): the gather and
    # the colour's y update alone (no geometry, no contractions), the
    # geometry loads replaced by constants, the read of y's entries taken
    # out of the update (a plain store)
    "K gather only": {
        "general_kernels.cu": ("  for (int i = 0; i < M; ++i) a.y[dof[i]] = yo[i] + a.coeff * acc[i];",
                               "  for (int i = 0; i < M; ++i) a.y[dof[i]] = yo[i] + xc[i];"),
    },
    "K no geometry": {
        "general_kernels.cu": ("    load_geometry<T, M, Affine>(a, cell, col, g);",
                               "    for (int e = 0; e < 6 * M; ++e) g[e / M][e % M] = A(1 + e % 3);"),
    },
    "K no y read": {
        "general_kernels.cu": ("  for (int i = 0; i < M; ++i) yo[i] = a.y[dof[i]];",
                               "  for (int i = 0; i < M; ++i) yo[i] = A(0);"),
    },
    # K's colour launches without the programmatic dependent launch (each
    # waits for the previous one to end)
    "K no overlap": {
        "general_kernels.cu": ("  attr[0].val.programmaticStreamSerializationAllowed = 1;",
                               "  attr[0].val.programmaticStreamSerializationAllowed = 0;"),
    },
}
POINT_ONLY = ABLATIONS["point value"]


@functools.cache
def patched_library(name: str) -> _cuda.KernelLibrary:
    """The kernel library built from a copy of ``csrc/`` with the patches of
    ``ABLATIONS[name]``."""
    src = _cuda.BUILD_DIR / ("ablation_" + re.sub(r"\W+", "_", name))
    shutil.rmtree(src, ignore_errors=True)
    src.mkdir(parents=True)
    for f in [*_cuda.CSRC.glob("*.cu"), *_cuda.CSRC.glob("*.cuh")]:
        text = f.read_text()
        if f.name in ABLATIONS[name]:
            line, patch = ABLATIONS[name][f.name]
            if text.count(line) != 1:
                raise RuntimeError(f"csrc/{f.name} does not hold the line the "
                                   f"ablation {name!r} replaces exactly once")
            text = text.replace(line, patch)
        (src / f.name).write_text(text)
    return _cuda.load(src)


class _StageTimer:
    """Device microseconds of each stage launch of kernel A (C with
    ``lean=False``) on the planar3d case: CUDA events over back-to-back
    launches with their arguments converted once, so the host's per-call
    checks do not pace them."""

    def __init__(self, case, pm, lean):
        self.case, self.pm = case, pm
        self.u, self.v = (torch.randn(pm.layout.padded_shape, dtype=pm.base.dtype,
                                      device=pm.base.device) for _ in range(2))
        self.bufs = [torch.zeros_like(self.u) for _ in range(5)]
        self.name = "wave_rk4_stage" if lean else "wave_rk4_full_stage"

    def launch_args(self, j, flip=False) -> tuple:
        """Stage ``j``'s launch arguments; ``flip``: its padding blocks on the
        grid's other end from where ``rk4step.stage_geometry`` puts them."""
        pm, case, b = self.pm, self.case, self.bufs
        g = pm.base.g_amplitude((0.0, 0.5, 0.5, 1.0)[j] * case.dt)
        args = rk4step.stage_launch_args(
            j, self.u, self.v, *b[2:], b[2 + j] if j < 3 else b[4], *b[:2],
            pm.face_w1, pm.face_w2, pm.src_x, pm.abc_x, case.dt, g, pm.base.c0,
            pm.layout, pm.stencil)
        return (*args[:-1], 1 - args[-1]) if flip else args  # the last: padding_first

    def stage_us(self, kl, flip=False, reps=200) -> list[float]:
        """Each stage's µs with library ``kl`` (``flip``: as launch_args)."""
        return [1e6 * timeit(_cuda.launcher(kl, self.name, self.u.dtype,
                                            self.pm.base.device,
                                            *self.launch_args(j, flip)), reps=reps)
                for j in range(4)]


def sweep_tiling(cells=(64, 32, 32), degree=4, dtype="f32", tile_x=None,
                 lean=True) -> dict:
    """Each stage's device time with its padding blocks where
    ``rk4step.stage_geometry`` puts them, then on the grid's other end."""
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA card")
    st = _StageTimer(*planar3d_app.build(cells, degree, dtype, tile_x, "cuda", lean),
                     lean)
    rows = []
    for flip in (False, True):
        us = st.stage_us(_cuda.library(), flip)
        geometry = [st.launch_args(j, flip)[-8:] for j in range(4)]
        rows.append({"padding_first": [bool(g[-1]) for g in geometry],
                     "grid": [list(g[3:6]) for g in geometry],
                     "tile": list(geometry[0][:2]), "chunk": geometry[0][2],
                     "smem": [g[6] for g in geometry], "stage_us": us,
                     "ms_per_step": sum(us) / 1e3})
    return {"card": card_line(), "cells": list(cells), "degree": degree,
            "dtype": dtype, "lean": lean,
            "padded_shape": list(st.pm.layout.padded_shape), "sweep": rows}


def _copy_rate(u: torch.Tensor) -> tuple[int, float]:
    """(bytes of one field, seconds of one ``Tensor.copy_`` of it)."""
    dst = torch.empty_like(u)
    return u.numel() * u.element_size(), timeit(lambda: dst.copy_(u), reps=200)


def _launch_us(kl, name, x, args, reps=200) -> float:
    return 1e6 * timeit(_cuda.launcher(kl, name, x.dtype, x.device, *args), reps=reps)


def _ablate_tma(pm, case) -> dict:
    """Kernel D or E (the path's RK4 kernel on ``pm``), one launch as built
    and with each ablation that patches its source, on random fields of the
    padded shape."""
    dev, dtype = pm.base.device, pm.base.dtype
    rand = lambda: torch.randn(pm.layout.padded_shape, dtype=dtype, device=dev)  # noqa: E731
    if pm.kernel == "3d":
        x, y = rand(), rand()
        name, label, src = "wave_apply_slab_tiled", "E", "slab_tiled.cu"
        args = wave.slab_launch_args(x, y, pm.layout, pm.slab_tables)
    else:
        x = rand()
        ins = (x, *(rand() for _ in range(5)))
        outs = tuple(rand() for _ in range(4))
        name, label, src = "wave_rk_stage_tiled", "D", "rk_stage_tiled.cu"
        args = wave.rk_stage_launch_args(
            *ins, *outs, 0.5 * case.dt, case.dt / 3.0, 1.0, pm.layout, pm.base.c0,
            pm.stencil, pm.face_w1, pm.face_w2, pm.src_x, pm.abc_x)
    ablated = {a: _launch_us(patched_library(a), name, x, args)
               for a, patches in ABLATIONS.items() if src in patches}
    nbytes, copy_s = _copy_rate(x)
    return {"kernel": label, "us_per_launch": _launch_us(_cuda.library(), name, x, args),
            "ablated_us_per_launch": ablated,
            "point_only_us_per_launch": ablated["point value"],
            "geometry": list(args[-7:]), "field_bytes": nbytes,
            "copy_us": copy_s * 1e6, "copy_gbps": 2 * nbytes / copy_s / 1e9}


def _ablate_lf(pm, case, label) -> dict:
    """Kernel H or I (the path's leapfrog kernel, ``label``): each phase's
    launch as built, with each ablation that patches ``lf_tiled.cu``, and
    with its padding layer on the other end of the grid from where
    ``tiling.tma_padding_first`` puts it, on random fields of the padded
    shape."""
    dev, dtype = pm.base.device, pm.base.dtype
    u, v, u_out, v_out = (torch.randn(pm.layout.padded_shape, dtype=dtype, device=dev)
                          for _ in range(4))
    dt = 0.71 * case.dt
    phases = {"OPEN": lfstep.LF_OPEN, "MID": lfstep.LF_MID, "CLOSE": lfstep.LF_CLOSE}
    if label == "H":
        del phases["MID"]

    def launch_args(ph, flip=False):
        args = lfstep.lf_launch_args(
            ph, u, v, None if ph == lfstep.LF_CLOSE else u_out, v_out, dt, 0.5,
            pm.layout, pm.base.c0, pm.stencil, pm.face_w1, pm.face_w2, pm.src_x,
            pm.abc_x)
        return (*args[:-1], 1 - args[-1]) if flip else args  # the last: padding_first

    def phase_us(kl, flip=False):
        return {name: _launch_us(kl, "wave_lf_phase_tiled", u, launch_args(ph, flip))
                for name, ph in phases.items()}

    nbytes, copy_s = _copy_rate(u)
    args = launch_args(lfstep.LF_OPEN)
    ablated = {a: phase_us(patched_library(a))
               for a, patches in ABLATIONS.items() if "lf_tiled.cu" in patches}
    ablated["padding layer " + ("last" if args[-1] else "first")] = phase_us(
        _cuda.library(), flip=True)
    return {"kernel": label, "phase_us": phase_us(_cuda.library()),
            "ablated_phase_us": ablated,
            "geometry": list(args[-7:]), "field_bytes": nbytes,
            "copy_us": copy_s * 1e6, "copy_gbps": 2 * nbytes / copy_s / 1e9}


def _ablate_boundary(pm, case) -> dict:
    """Kernel J's step-boundary launch on ``pm`` as built and with each
    ablation that patches ``rk42_tiled.cu``, on random fields of the padded
    shape."""
    dev, dtype = pm.base.device, pm.base.dtype
    u0, v0, kv0, kv1, kv2, u1, v1, kv = (
        torch.randn(pm.layout.padded_shape, dtype=dtype, device=dev) for _ in range(8))
    args = rk42step.boundary_launch_args(
        u0, v0, kv0, kv1, kv2, u1, v1, kv, pm.face_w1, pm.face_w2, pm.src_x, pm.abc_x,
        case.dt, 0.5, pm.base.c0, pm.layout, pm.stencil)
    name = "wave_rk42_boundary_tiled"
    nbytes, copy_s = _copy_rate(u0)
    return {"kernel": "J boundary",
            "us_per_launch": _launch_us(_cuda.library(), name, u0, args),
            "ablated_us_per_launch": {a: _launch_us(patched_library(a), name, u0, args)
                                      for a, patches in ABLATIONS.items()
                                      if {"rk42_tiled.cu", "stencil_tiled.cuh"} & set(patches)},
            "geometry": list(args[-7:]), "field_bytes": nbytes,
            "copy_us": copy_s * 1e6, "copy_gbps": 2 * nbytes / copy_s / 1e9}


def ablate_bp1(cells=(64, 64, 64), degree=4, dtype="f32") -> dict:
    """Kernel G's apply on the BP1 problem of ``cells`` (a unit box, the
    layout ``cg_bench`` builds) as built and with each ablation that
    patches ``mass_tiled.cu`` (CUDA events over back-to-back launches), and
    one field copy."""
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA card")
    dev = torch.device("cuda")
    layout, tables, _ = bp1_setup(box_mesh(tuple(cells), (1.0, 1.0, 1.0)), degree,
                                  DTYPES[dtype], dev)
    x = layout.pad(torch.randn(layout.shape, dtype=DTYPES[dtype], device=dev))
    y = torch.empty_like(x)
    args = mass_launch_args(x, y, layout, tables)
    nbytes, copy_s = _copy_rate(x)
    return {"card": card_line(), "cells": list(cells), "degree": degree,
            "dtype": dtype, "padded_shape": list(layout.padded_shape), "kernel": "G",
            "us_per_launch": _launch_us(_cuda.library(), "wave_mass_tiled", x, args),
            "ablated_us_per_launch": {
                a: _launch_us(patched_library(a), "wave_mass_tiled", x, args)
                for a, patches in ABLATIONS.items()
                if {"mass_tiled.cu", "stencil_tiled.cuh"} & set(patches)},
            "geometry": list(args[-7:]), "field_bytes": nbytes,
            "copy_us": copy_s * 1e6, "copy_gbps": 2 * nbytes / copy_s / 1e9}


def _ablations_of(src: str) -> list[str]:
    return [a for a, patches in ABLATIONS.items() if src in patches]


def ablate_stiffness(cells=(64, 64, 64), degree=4, dtype="f32") -> dict:
    """Kernel F's apply on the unpadded dof grid of ``cells`` (a unit box:
    at 64^3 cells the grid of ``operators_bench --op stiffness``, P7) as
    built and with each ablation that patches ``stiffness_tiled.cu`` (CUDA
    events over back-to-back launches), and one field copy."""
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA card")
    dev, dt = torch.device("cuda"), DTYPES[dtype]
    ops = StructuredOperators(box_mesh(tuple(cells), (1.0, 1.0, 1.0)), degree, dtype=dt)
    tables = GridStiffnessTables(*tables_from_numpy(stiffness_grid_tables(
        ops._sepA, ops._seplines, ops.grid_shape, degree, -1500.0**2, dt), dev, dt))
    x = torch.randn(ops.grid_shape, dtype=dt, device=dev)
    args = stiffness_launch_args(x, torch.empty_like(x), tables, degree)
    name = "wave_stiffness_tiled"
    nbytes, copy_s = _copy_rate(x)
    return {"card": card_line(), "cells": list(cells), "degree": degree,
            "dtype": dtype, "grid_shape": list(ops.grid_shape), "kernel": "F",
            "us_per_launch": _launch_us(_cuda.library(), name, x, args),
            "ablated_us_per_launch": {a: _launch_us(patched_library(a), name, x, args)
                                      for a in _ablations_of("stiffness_tiled.cu")},
            "geometry": list(args[-7:]), "field_bytes": nbytes,
            "copy_us": copy_s * 1e6, "copy_gbps": 2 * nbytes / copy_s / 1e9}


def ablate_flat(cells=(64, 32, 32), degree=4, dtype="f32", tile_x=None) -> dict:
    """Kernel B's apply on the planar3d layout of ``cells`` (the P1 layout,
    (384, 144, 144), by default) as built and with each ablation that
    patches ``flat_tiled.cu`` (CUDA events over back-to-back launches, x
    random in the interior and 0 in the padding), and one field copy."""
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA card")
    _, pm = planar3d_app.build(cells, degree, dtype, tile_x, "cuda")
    x = pm.layout.pad(torch.randn(pm.layout.shape, dtype=pm.base.dtype,
                                  device=pm.base.device))
    args = wave.flat_launch_args(x, torch.empty_like(x), pm.layout, pm.stencil)
    name = "wave_apply_flat_tiled"
    nbytes, copy_s = _copy_rate(x)
    return {"card": card_line(), "cells": list(cells), "degree": degree,
            "dtype": dtype, "padded_shape": list(pm.layout.padded_shape), "kernel": "B",
            "us_per_launch": _launch_us(_cuda.library(), name, x, args),
            "ablated_us_per_launch": {a: _launch_us(patched_library(a), name, x, args)
                                      for a in _ablations_of("flat_tiled.cu")},
            "geometry": list(args[-7:]), "field_bytes": nbytes,
            "copy_us": copy_s * 1e6, "copy_gbps": 2 * nbytes / copy_s / 1e9}


def ablate(cells=(64, 32, 32), degree=4, dtype="f32", tile_x=None,
           lean=True, integrator="rk4", two_step=False) -> dict:
    """What holds the path's kernel back: kernel A (or C) stage by stage,
    or kernel D or E per launch (the path at p > 8, or where the step
    kernel does not apply), or with ``integrator='leapfrog'`` each phase of
    kernel I (or H), as built and with the stencil replaced by the point
    value (D, E, H and I also without each part of ABLATIONS that patches
    their source), or with ``two_step`` kernel J's step-boundary launch as
    built and without each part of ABLATIONS that patches it; and the copy
    rate of one state field (``Tensor.copy_``, a measuring stick only), the
    HBM rate a streaming kernel can reach on this card."""
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA card")
    case, pm = planar3d_app.build(cells, degree, dtype, tile_x, "cuda", lean)
    head = {"card": card_line(), "cells": list(cells), "degree": degree,
            "dtype": dtype, "lean": lean, "integrator": integrator,
            "padded_shape": list(pm.layout.padded_shape)}
    if two_step:
        if pm.rk42_unavailable is not None:
            raise ValueError(f"the two-step path is unavailable: {pm.rk42_unavailable}")
        return {**head, **_ablate_boundary(pm, case)}
    if integrator == "leapfrog" and pm.kernel != "3d":
        label = ("I" if pm.lf2_unavailable is None
                 else "H" if pm.lf_unavailable is None else None)
        if label is None:
            raise ValueError(f"the leapfrog path at p = {degree} runs on force: "
                             "ablate its RK4 kernel instead")
        return {**head, **_ablate_lf(pm, case, label)}
    if pm.kernel == "3d" or pm.step_unavailable is not None:
        return {**head, **_ablate_tma(pm, case)}
    st = _StageTimer(case, pm, lean)
    full = st.stage_us(_cuda.library())
    ablated = {a: st.stage_us(patched_library(a)) for a in _ablations_of("rk4_tiled.cu")}
    point = ablated["point value"]
    nbytes, copy_s = _copy_rate(st.u)
    return {**head, "kernel": "C" if not lean else "A",
            "stage_us": full, "point_only_stage_us": point,
            "ablated_stage_us": ablated,
            "ms_per_step": sum(full) / 1e3,
            "point_only_ms_per_step": sum(point) / 1e3,
            "field_bytes": nbytes, "copy_us": copy_s * 1e6,
            "copy_gbps": 2 * nbytes / copy_s / 1e9}


def _device_events(prof):
    """(name, device microseconds) of every kernel the profiler saw."""
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def profile_bp1(cells=(64, 64, 64), degree=4, dtype="f32", kmax=50,
                rtol=1e-4) -> dict:
    """Where one BP1 CG solve's time goes (see the module docstring)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA card")
    dev = torch.device("cuda")
    dt = DTYPES[dtype]
    layout, tables, _ = bp1_setup(box_mesh(tuple(cells), (1.0, 1.0, 1.0)), degree,
                                  dt, dev)
    b = layout.pad(torch.as_tensor(
        np.random.default_rng(0).standard_normal(layout.shape), dtype=dt, device=dev))

    def solve():
        return cg(lambda v: mass_apply(v, layout, tables), b, kmax=kmax, rtol=rtol)

    solve()
    sync(dev)
    t0 = time.perf_counter()
    _, iters, _ = solve()
    sync(dev)
    synced_ms = (time.perf_counter() - t0) * 1e3
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        sync(dev)
        w0 = time.perf_counter()
        solve()
        sync(dev)
        wall_us = (time.perf_counter() - w0) * 1e6
    events = _device_events(prof)
    g_us = [us for name, us in events if "mass_tiled_kernel" in name]
    other_us = sum(us for name, us in events if "mass_tiled_kernel" not in name)
    if len(g_us) != 1 + iters:
        raise RuntimeError(f"the profiler saw {len(g_us)} kernel G launches, "
                           f"the solve makes {1 + iters}: it does not trace "
                           "this card; time with CUDA events instead")
    traced = prof.events()
    busy_us = device_busy_us(traced)
    tests, wait_us = host_span_us(traced, ("wave.cg.stop_test",))
    _, issue_us = host_span_us(traced, ("wave.cg.iter",), ("wave.cg.stop_test",))
    return {
        "card": card_line(),
        "cells": list(cells), "degree": degree, "dtype": dtype,
        "ndofs": int(np.prod(layout.shape)),
        "padded_shape": list(layout.padded_shape),
        "iters": iters, "kmax": kmax, "rtol": rtol,
        "synced_ms_per_solve": synced_ms,
        "profiled_wall_ms_per_solve": wall_us / 1e3,
        "matvec_launches": len(g_us),
        "matvec_us_per_launch": sum(g_us) / len(g_us),
        "matvec_ms_per_solve": sum(g_us) / 1e3,
        "vector_kernel_launches": len(events) - len(g_us),
        "vector_ms_per_solve": other_us / 1e3,
        "host_ms_per_solve": (wall_us - busy_us) / 1e3,
        "device_busy_share": busy_us / wall_us,
        "per_iteration_ms": {
            "matvec": sum(g_us) / 1e3 / iters,
            "vector_ops": other_us / 1e3 / iters,
            "host_and_sync": (wall_us - busy_us) / 1e3 / iters,
        },
        "stop_tests": tests,
        "host_issue_ms_per_iter": issue_us / 1e3 / iters,
        "host_wait_ms_per_iter": wait_us / 1e3 / iters,
    }


def profile_general(cells=(64, 32, 32), degree=4, dtype="f32", steps=20,
                    warmup=2) -> dict:
    """Where RK4 steps of the explicit-dofmap model spend their time (see
    the module docstring)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA card")
    md, setup_s = general_solve.build(cells, degree, dtype)
    dev = md.device
    dt = 0.5 * general_solve.min_edge(md.mesh) / (md.c0 * degree * degree)
    md.solve_n(0.0, dt, warmup)
    sync(dev)
    t0 = time.perf_counter()
    md.solve_n(0.0, dt, steps)
    t1 = time.perf_counter()
    sync(dev)
    t2 = time.perf_counter()
    n0 = general_apply_cuda.launches
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        sync(dev)
        w0 = time.perf_counter()
        md.solve_n(0.0, dt, steps)
        sync(dev)
        wall_us = (time.perf_counter() - w0) * 1e6
    applies = general_apply_cuda.launches - n0
    ncolours = md.ops.tables("stiffness", dev).ncolours
    events = _device_events(prof)
    el = [us for name, us in events if "general_stiffness_kernel" in name]
    zero = [us for name, us in events if "general_zero_kernel" in name]
    other_us = sum(us for name, us in events if "general_" not in name)
    if (applies != 4 * steps or len(el) != applies * ncolours
            or len(zero) != applies):
        raise RuntimeError(
            f"{steps} RK4 steps make {4 * steps} applies of kernel K, each one "
            f"zero launch and {ncolours} colour launches; counted {applies} "
            f"applies, the profiler saw {len(el)} colour and {len(zero)} zero "
            "launches (no device time: time with CUDA events instead)")
    busy_us = device_busy_us(prof.events())
    return {
        "card": card_line(),
        "cells": list(cells), "degree": degree, "dtype": dtype,
        "ndofs": md.ndofs, "affine": md.ops.affine, "setup_s": setup_s,
        "steps": steps, "k_applies": applies, "colours": ncolours,
        "element_us_per_apply": sum(el) / applies,
        "zero_us_per_apply": sum(zero) / applies,
        "colour_us": [sum(el[c::ncolours]) / applies for c in range(ncolours)],
        "k_ms_per_step": (sum(el) + sum(zero)) / 1e3 / steps,
        "vector_kernel_launches_per_step": (len(events) - len(el) - len(zero)) / steps,
        "vector_ms_per_step": other_us / 1e3 / steps,
        "host_ms_per_step": (wall_us - busy_us) / 1e3 / steps,
        "profiled_wall_ms_per_step": wall_us / 1e3 / steps,
        "device_busy_share": busy_us / wall_us,
        "enqueue_ms_per_step": (t1 - t0) / steps * 1e3,
        "synced_ms_per_step": (t2 - t0) / steps * 1e3,
    }


def ablate_general(cells=(64, 32, 32), degree=4, dtype="f32", reps=100) -> dict:
    """Kernel K's stiffness apply on the perturbed box of ``cells``
    (CUDA events over back-to-back applies, the arguments converted once):
    as built, with each ablation of ABLATIONS that patches
    ``general_kernels.cu``, and with all cells in one launch (the colour
    split taken out: the sums race, only the time counts)."""
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA card")
    md, setup_s = general_solve.build(cells, degree, dtype)
    dev = md.device
    t = md.ops.tables("stiffness", dev)
    x = torch.randn(md.ndofs, dtype=md.dtype, device=dev)
    y = torch.empty_like(x)
    cpb = general.launch_shape(t.mode, t.m, t.nq, x.element_size())[0]

    def us(kl, colour_starts=None):
        return _launch_us(kl, "wave_general_apply", x,
                          general.launch_args(x, y, t, -1500.0**2, colour_starts),
                          reps=reps)

    built = us(_cuda.library())
    one = us(_cuda.library(), torch.tensor([0, t.ncells], dtype=torch.int32))
    return {"card": card_line(), "cells": list(cells), "degree": degree, "dtype": dtype,
            "ndofs": md.ndofs, "setup_s": setup_s, "colours": t.ncolours,
            "cells_per_block": cpb, "us_per_apply": built,
            "ablated_us_per_apply": {
                **{a: us(patched_library(a)) for a, patches in ABLATIONS.items()
                   if "general_kernels.cu" in patches},
                "K one launch": one}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, nargs=3, default=(64, 32, 32))
    ap.add_argument("--degree", type=int, default=4)
    ap.add_argument("--dtype", choices=("f32", "f64", "bf16"), default="f32",
                    help="the state's dtype (bf16: the box's paths, kernels A to F, "
                         "H, I and J; G and K raise)")
    ap.add_argument("--tile-x", type=int, default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--integrator", choices=("rk4", "leapfrog"), default="rk4")
    ap.add_argument("--full-tableau", action="store_true")
    ap.add_argument("--two-step", action="store_true",
                    help="RK4 through the 2-step kernel J")
    ap.add_argument("--bp1", action="store_true",
                    help="profile one BP1 CG solve (kernel G) on a unit box "
                         "of --cells")
    ap.add_argument("--general", action="store_true",
                    help="profile RK4 steps of the explicit-dofmap model "
                         "(kernel K) on the perturbed box of --cells; with "
                         "--ablate, K's stiffness apply as built and ablated")
    ap.add_argument("--stiffness", action="store_true",
                    help="with --ablate, kernel F on the unpadded dof grid of a "
                         "unit box of --cells")
    ap.add_argument("--flat", action="store_true",
                    help="with --ablate, kernel B on the planar3d layout of --cells")
    ap.add_argument("--sweep-tiling", action="store_true",
                    help="time each stage of kernel A (C with --full-tableau) "
                         "with its padding layer first and last")
    ap.add_argument("--ablate", action="store_true",
                    help="time the path's kernel (each stage of A, or C "
                         "with --full-tableau; D or E where the path takes "
                         "them; each phase of I or H with --integrator "
                         "leapfrog; J's step boundary with --two-step; G "
                         "with --bp1) as built and with the stencil replaced "
                         "by the point value, and one field copy")
    args = ap.parse_args(argv)
    if (args.stiffness or args.flat) and not args.ablate:
        ap.error("--stiffness and --flat select the kernel --ablate times")
    if args.ablate and args.general:
        out = ablate_general(args.cells, args.degree, args.dtype)
        print(out["card"])
        print(f"kernel K stiffness, {out['ndofs']} dofs, {out['colours']} colours, "
              f"{out['cells_per_block']} cells a block: {out['us_per_apply']:.2f} "
              "us/apply; " + "; ".join(f"{a}: {us:.2f}" for a, us in
                                       out["ablated_us_per_apply"].items()))
        print(json.dumps(out))
        return
    if args.ablate and args.bp1:
        out = ablate_bp1(args.cells, args.degree, args.dtype)
    elif args.ablate and args.stiffness:
        out = ablate_stiffness(args.cells, args.degree, args.dtype)
    elif args.ablate and args.flat:
        out = ablate_flat(args.cells, args.degree, args.dtype, args.tile_x)
    elif args.ablate:
        out = ablate(args.cells, args.degree, args.dtype, args.tile_x,
                     lean=not args.full_tableau, integrator=args.integrator,
                     two_step=args.two_step)
    if args.ablate:
        print(out["card"])
        if "phase_us" in out:
            print(f"kernel {out['kernel']} (tiling {out['geometry']}): phases "
                  + ", ".join(f"{k} {v:.2f}" for k, v in out["phase_us"].items())
                  + " us; " + "; ".join(
                      f"{a}: " + ", ".join(f"{k} {v:.2f}" for k, v in ph.items())
                      for a, ph in out["ablated_phase_us"].items()), end="")
        elif "stage_us" in out:
            print(f"kernel {out['kernel']}: stages "
                  f"{', '.join(f'{t:.2f}' for t in out['stage_us'])} us "
                  f"({out['ms_per_step']:.4f} ms/step); stencil replaced by the point "
                  f"value: {', '.join(f'{t:.2f}' for t in out['point_only_stage_us'])} "
                  f"us ({out['point_only_ms_per_step']:.4f} ms/step); " + "; ".join(
                      f"{a}: {sum(us) / 1e3:.4f} ms/step"
                      for a, us in out["ablated_stage_us"].items()), end="")
        else:
            print(f"kernel {out['kernel']} (tiling {out['geometry']}): "
                  f"{out['us_per_launch']:.2f} us/launch; "
                  + "; ".join(f"{a}: {us:.2f}"
                              for a, us in out["ablated_us_per_launch"].items()),
                  end="")
        print(f"; one field copy {out['copy_us']:.2f} us, {out['copy_gbps']:.1f} GB/s")
        print(json.dumps(out))
        return
    if args.sweep_tiling:
        out = sweep_tiling(args.cells, args.degree, args.dtype, args.tile_x,
                           lean=not args.full_tableau)
        print(out["card"])
        for r in out["sweep"]:
            print(f"padding first {r['padding_first']}: tile {r['tile']}, chunk "
                  f"{r['chunk']}, grids {r['grid']}: stages "
                  f"{', '.join(f'{t:.2f}' for t in r['stage_us'])} us, "
                  f"{r['ms_per_step']:.4f} ms/step")
        print(json.dumps(out))
        return
    if args.general:
        out = profile_general(args.cells, args.degree, args.dtype, args.steps)
        print(out["card"])
        print(f"general RK4, {out['ndofs']} dofs, {out['steps']} steps: kernel K "
              f"{out['k_ms_per_step']:.4f} ms/step ({out['colours']} colour launches "
              f"{out['element_us_per_apply']:.2f} us + zero "
              f"{out['zero_us_per_apply']:.2f} us per apply, 4 applies), "
              f"vector ops {out['vector_ms_per_step']:.4f} ms/step, host "
              f"{out['host_ms_per_step']:.4f} ms/step; busy share "
              f"{out['device_busy_share']:.4f}; synced {out['synced_ms_per_step']:.4f} "
              "ms/step without the profiler")
        print(json.dumps(out))
        return
    if args.bp1:
        out = profile_bp1(args.cells, args.degree, args.dtype)
        print(out["card"])
        print(f"BP1 CG, {out['ndofs']} dofs, {out['iters']} iterations: "
              f"matvec {out['matvec_ms_per_solve']:.3f} ms ({out['matvec_launches']} "
              f"x {out['matvec_us_per_launch']:.2f} us), vector ops "
              f"{out['vector_ms_per_solve']:.3f} ms ({out['vector_kernel_launches']} "
              f"launches), host {out['host_ms_per_solve']:.3f} ms; busy share "
              f"{out['device_busy_share']:.4f}; host issue "
              f"{out['host_issue_ms_per_iter']:.4f}, wait {out['host_wait_ms_per_iter']:.4f} "
              f"ms/iter ({out['stop_tests']} stop tests); synced "
              f"{out['synced_ms_per_solve']:.3f} ms/solve without the profiler")
        print(json.dumps(out))
        return
    out = profile(args.cells, args.degree, args.dtype, args.tile_x, args.steps,
                  integrator=args.integrator, lean=not args.full_tableau,
                  two_step=args.two_step)
    print(out["card"])
    print(out["solver_path"])
    for k in out["kernels"]:
        print(f"{k['kernel']}: {k['us_per_launch']:.2f} us/launch "
              f"x {k['launches']}, {k['fields']} fields, "
              f"{k['model_gbps']:.1f} GB/s (model)")
    print(f"kernels {out['kernel_us_per_step']:.1f} us/step, other device "
          f"kernels {out['other_device_us_per_step']:.1f} us/step; busy share "
          f"{out['device_busy_share']:.4f} and host issue "
          f"{out['host_issue_ms_per_step']} ms/step under the profiler; enqueue "
          f"{out['enqueue_ms_per_step']:.4f} ms/step, synced "
          f"{out['synced_ms_per_step']:.4f} ms/step without it")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
