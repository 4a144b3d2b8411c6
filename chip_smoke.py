#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (wave_fenics_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure raises, so the script exits non-zero and
never prints its last line:

1. device: a CUDA card, its name and power limit (nvidia-smi), TF32 off
   for the plain versions;
2. build: nvcc compiles csrc/*.cu for sm_90a (ops/_cuda.py);
3. kernel B (stiffness/m) against its plain version: f64 at (4,2,2) cells,
   f32 at the headline size (64x32x32 cells, p=4, tile 48), with times;
4. kernel A (lean RK4 step) against the plain lean step: f64 at (4,2,2),
   p in {2, 4}, 25 steps; f32 at the headline size, 50 steps; with times;
5. physics: the f64 analytic plane wave (16x2x2 cells, 6 mm) through
   solve_step_n on the kernel;
6. the main path: the app's full headline solve (4,276,737 dofs, 1,489
   steps) through kernel A. Both launch counts are reset just before the
   app's run and read just after it: kernel A must have run every step,
   kernel B not at all (the step path does not use it). Then kernel B's
   own path, the f1-path RK4 (PaddedLinearWave.solve_n), for two steps on
   the same model against the step path, with its own count; then a
   two-point rate of solve_step_n.

It prints one JSON line of per-kernel results ("kernels": the main path's,
with the app run's launch counts; "off_path_kernels": kernel B) and, last,
one JSON line ``{"ok": true, "device": {...}}``. Without a CUDA card, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HEADLINE = dict(cells=(64, 32, 32), degree=4)


def phase(msg: str) -> None:
    print(f"== {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def main() -> None:
    import numpy as np
    import torch

    # -- 1. device ----------------------------------------------------------
    phase("device")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: torch.cuda.is_available() is False")
    if not (ROOT / "wave_fenics_tpu_torch" / "csrc").is_dir():
        raise RuntimeError(f"{ROOT} is not a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    # the plain versions are references: full f32 matmuls, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from wave_fenics_tpu_torch.apps import planar3d_app
    from wave_fenics_tpu_torch.core.basis import gll_points_weights
    from wave_fenics_tpu_torch.core.mesh import FacetTags, box_mesh
    from wave_fenics_tpu_torch.models.linear_wave import LinearWave
    from wave_fenics_tpu_torch.models.linear_wave_padded import PaddedLinearWave
    from wave_fenics_tpu_torch.models.planar3d import (
        analytic_plane_wave,
        planar3d_case,
    )
    from wave_fenics_tpu_torch.ops import _cuda, rk4step, wave
    from wave_fenics_tpu_torch.utils.timing import Timer, timeit

    # -- 2. build -----------------------------------------------------------
    phase("build")
    t0 = time.perf_counter()
    kl = _cuda.library()
    print(f"built {kl.path.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {kl.build_seconds:.2f} s)")
    for line in kl.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.split("ptxas info    :")[-1].strip())

    def small_model(p, dtype=torch.float64):
        mesh = box_mesh((4, 2, 2), (0.01, 0.005, 0.005),
                        facet_tags=FacetTags({1: (0,), 2: (1,)}))
        return PaddedLinearWave(LinearWave(mesh, p=p, dtype=dtype, device=dev),
                                tile_x=16)

    def random_padded(layout, seed, dtype):
        x = np.zeros(layout.padded_shape)
        x[layout.interior] = np.random.default_rng(seed).standard_normal(layout.shape)
        return torch.as_tensor(x, dtype=dtype, device=dev)

    def plain_solve(pm, dt, nsteps):
        """solve_step_n's loop on the plain lean step (same device)."""
        u, v = pm.zero_state()
        t, b = 0.0, pm.base
        for _ in range(nsteps):
            gs = [b.g_amplitude(t + c * dt) for c in (0.0, 0.5, 0.5, 1.0)]
            u, v = rk4step.rk4_step_lean_plain(u, v, dt, gs, pm.layout, b.c0,
                                               pm.step_tables)
            t = t + dt
        return u, v

    # -- 3. kernel B --------------------------------------------------------
    phase("kernel B (apply_flat) against apply_flat_plain")
    pm = small_model(4)
    x = random_padded(pm.layout, 1, torch.float64)
    yk = wave.apply_flat_cuda(x, pm.layout, pm.stencil)
    yp = wave.apply_flat_plain(x, pm.layout, pm.flat_tables)
    torch.cuda.synchronize()
    rel = float((yk - yp).abs().max() / yp.abs().max())
    print(f"f64 (4,2,2) p=4: max|err|/max|ref| = {rel:.3e} (limit 1e-12)")
    check(rel <= 1e-12, "kernel B f64 agreement")

    case, hpm = planar3d_app.build(**HEADLINE, dtype="f32", device="cuda")
    print(f"headline: {case.model.ops.ndofs} dofs, padded "
          f"{hpm.layout.padded_shape}, tile_x {hpm.layout.tile_x}, "
          f"{case.nsteps} steps")
    x = random_padded(hpm.layout, 2, torch.float32)
    yk = wave.apply_flat_cuda(x, hpm.layout, hpm.stencil)
    yp = wave.apply_flat_plain(x, hpm.layout, hpm.flat_tables)
    torch.cuda.synchronize()
    b_err = float((yk - yp).abs().max())
    rel = b_err / float(yp.abs().max())
    print(f"f32 headline: max|err| = {b_err:.6e}, max|err|/max|ref| = "
          f"{rel:.3e} (limit 1e-5)")
    check(rel <= 1e-5, "kernel B f32 agreement")
    outside = yk.clone()
    outside[hpm.layout.interior] = 0.0
    check(float(outside.abs().max()) == 0.0, "kernel B keeps the padding zero")
    out_b = torch.empty_like(x)
    b_ms = 1e3 * timeit(lambda: wave.apply_flat_cuda(x, hpm.layout, hpm.stencil, out=out_b))
    b_plain_ms = 1e3 * timeit(
        lambda: wave.apply_flat_plain(x, hpm.layout, hpm.flat_tables), reps=5)
    print(f"f32 headline: kernel {b_ms:.4f} ms/apply, plain {b_plain_ms:.4f} "
          f"ms/apply [{smi}]")

    # -- 4. kernel A --------------------------------------------------------
    phase("kernel A (rk4 stage kernels) against rk4_step_lean_plain")
    for p in (2, 4):
        spm = small_model(p)
        uk, vk, _ = spm.solve_step_n(0.0, 1e-9, 25)
        up, vp = plain_solve(spm, 1e-9, 25)
        torch.cuda.synchronize()
        vmax = float(vp.abs().max())
        eu = float((uk - up).abs().max()) / max(vmax, 1.0)
        ev = float((vk - vp).abs().max()) / vmax
        print(f"f64 (4,2,2) p={p}, 25 steps: u err/max|v| = {eu:.3e}, "
              f"v err/max|v| = {ev:.3e} (limit 1e-12)")
        check(vmax > 0 and eu <= 1e-12 and ev <= 1e-12, f"kernel A f64 p={p}")

    uk, vk, _ = hpm.solve_step_n(case.t0, case.dt, 50)
    up, vp = plain_solve(hpm, case.dt, 50)
    torch.cuda.synchronize()
    vmax = float(vp.abs().max())
    a_err = max(float((uk - up).abs().max()), float((vk - vp).abs().max()))
    rel = a_err / vmax
    print(f"f32 headline, 50 steps: max|err| = {a_err:.6e}, max|err|/max|v| = "
          f"{rel:.3e} (limit 1e-4)")
    check(vmax > 0 and rel <= 1e-4, "kernel A f32 agreement")
    gs = [hpm.base.g_amplitude(c * case.dt) for c in (0.0, 0.5, 0.5, 1.0)]
    bufs = [torch.empty_like(uk) for _ in range(5)]
    a_ms = 1e3 * timeit(lambda: rk4step.rk4_step_lean_cuda(
        uk, vk, case.dt, gs, hpm.layout, hpm.base.c0, hpm.stencil,
        hpm.step_tables.W1, hpm.step_tables.W2, hpm.src_x, hpm.abc_x,
        out=tuple(bufs[:2]), scratch=tuple(bufs[2:])))
    a_plain_ms = 1e3 * timeit(lambda: rk4step.rk4_step_lean_plain(
        uk, vk, case.dt, gs, hpm.layout, hpm.base.c0, hpm.step_tables), reps=5)
    print(f"f32 headline: kernel {a_ms:.4f} ms/step "
          f"({rk4step.LAUNCHES_PER_STEP} launches), plain {a_plain_ms:.4f} "
          f"ms/step [{smi}]")
    del uk, vk, up, vp, bufs, x, yk, yp, outside, out_b

    # -- 5. physics ---------------------------------------------------------
    phase("physics: f64 analytic plane wave through solve_step_n")
    pcase = planar3d_case(ncells=(16, 2, 2), domain_length=6.0e-3,
                          dtype=torch.float64, device=dev)
    ppm = PaddedLinearWave(pcase.model, tile_x=16)
    u, _, n = ppm.solve_step_n(pcase.t0, pcase.dt, pcase.nsteps)
    u = ppm.to_grid(u).cpu().numpy()
    m = pcase.model
    nodes, _ = gll_points_weights(m.p + 1)
    line = m.mesh.h[0] * (np.arange(m.mesh.shape[0])[:, None] + nodes[None, :])
    xs = np.concatenate([line[:, :-1].ravel(), line[-1:, -1]])
    t_end = pcase.t0 + n * pcase.dt
    u_line = u[:, 0, 0]
    u_exact = analytic_plane_wave(xs, t_end, pcase)
    rel_l2 = float(np.linalg.norm(u_line - u_exact) / np.linalg.norm(u_exact))
    spread = float(np.abs(u - u_line[:, None, None]).max() / np.abs(u).max())
    print(f"{n} steps: relative L2 = {rel_l2:.3e} (limit 1e-5), transverse "
          f"spread/max|u| = {spread:.3e} (limit 1e-6)")
    check(rel_l2 < 1e-5 and spread < 1e-6, "analytic plane wave")

    # -- 6. the main path ---------------------------------------------------
    phase("main path: planar3d_app.run() at the headline size")
    rk4step.rk4_step_lean_cuda.launches = 0
    wave.apply_flat_cuda.launches = 0
    out = planar3d_app.run(**HEADLINE, dtype="f32", device="cuda")
    a_launches = rk4step.rk4_step_lean_cuda.launches
    b_launches = wave.apply_flat_cuda.launches
    print(json.dumps(out))
    check(out["ndofs"] == 4_276_737 and out["nsteps"] == case.nsteps,
          "headline size and full step count")
    # the app runs one warm-up step before the timed solve
    want = rk4step.LAUNCHES_PER_STEP * (out["nsteps"] + 1)
    print(f"main path launches: kernel A {a_launches} = "
          f"{rk4step.LAUNCHES_PER_STEP} x ({out['nsteps']} solve steps + 1 "
          f"warm-up step); kernel B {b_launches} (not on the step path)")
    check(a_launches == want, f"kernel A launched {a_launches} times, want {want}")
    check(b_launches == 0, f"the step path launched kernel B {b_launches} times")
    check(math.isfinite(out["u_norm"]) and out["u_norm"] > 0, "finite, nonzero u")

    # kernel B's own path: the f1-path RK4 (PaddedLinearWave.solve_n) on the
    # same full-width model, two steps, against the step path from the same
    # initial state; counted apart from the main path
    case, hpm = planar3d_app.build(**HEADLINE, dtype="f32", device="cuda")
    wave.apply_flat_cuda.launches = 0
    uf, vf = hpm.solve_n(case.t0, case.dt, 2)
    f1_launches = wave.apply_flat_cuda.launches
    us, vs, _ = hpm.solve_step_n(case.t0, case.dt, 2)
    torch.cuda.synchronize()
    vmax = float(vs.abs().max())
    rel = float((vf - vs).abs().max()) / vmax
    print(f"f1 path vs step path, 2 steps: max|dv|/max|v| = {rel:.3e} "
          f"(limit 1e-4); kernel B launches in solve_n {f1_launches}")
    check(vmax > 0 and rel <= 1e-4, "f1 path agrees with the step path")
    check(f1_launches == 8, f"kernel B launched {f1_launches} times, want 8")

    tm = Timer(dev)
    n_hi, n_lo = 600, 150
    for n in (n_lo, n_hi):
        with tm(f"n{n}"):
            hpm.solve_step_n(case.t0, case.dt, n)
    per_step = (tm.seconds(f"n{n_hi}") - tm.seconds(f"n{n_lo}")) / (n_hi - n_lo)
    check(per_step > 0, "two-point rate")
    print(f"two-point rate ({n_hi}-{n_lo} steps): {per_step * 1e3:.4f} ms/step, "
          f"{out['ndofs'] / per_step / 1e9:.4f} GDoF*steps/s [{smi}]")

    # "kernels": the main path's kernels, with the launches of the app run;
    # "off_path_kernels": ported kernels the app's step path does not run,
    # with their launches in that run (0) and in their own path's check
    kernels = [{
        "name": "rk4_stage_kernel (kernel A: lean RK4 step, 4 stage launches)",
        "route": "cuda",
        "source": "wave_fenics_tpu_torch/csrc/wave_kernels.cu",
        "replaces": "wave_fenics_tpu/ops/pallas_rk4step.py:201",
        "launches": a_launches,
        "max_abs_err": a_err,
        "ms": a_ms,
        "plain_ms": a_plain_ms,
    }]
    off_path = [{
        "name": "apply_flat_kernel (kernel B: stiffness/m on the flat layout)",
        "route": "cuda",
        "source": "wave_fenics_tpu_torch/csrc/wave_kernels.cu",
        "replaces": "wave_fenics_tpu/ops/pallas_wave.py:336",
        "launches": b_launches,
        "f1_check_launches": f1_launches,
        "max_abs_err": b_err,
        "ms": b_ms,
        "plain_ms": b_plain_ms,
    }]
    print(json.dumps({"kernels": kernels, "off_path_kernels": off_path}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
