"""The benchmark's one input generator: a traffic file's ``inputs`` object
says what to make, and ``--seed`` makes it, on the device, with a
``torch.Generator`` there. Every seed makes the same number of inputs of
the same sizes; only the values differ.

Kinds:

- ``smooth_modes``: states (u, v) of a wave on the configuration's GLL dof
  grid, as a run resumed from a snapshot starts: each field a sum of
  ``modes`` products cos(pi kx x / Lx + phi) cos(pi ky y / Ly)
  cos(pi kz z / Lz), with integer wavenumbers below ``max_wavenumber``
  (per axis) and amplitudes uniform in [-1, 1] times ``u_scale`` p0 (u)
  or ``v_scale`` p0 2 pi f0 (v).
- ``normal``: right-hand sides b on the dof grid, standard normal.

Inputs are made in float64 and handed out in ``dtype`` (float32 by
default): the program and the reference get the same values.
"""

from __future__ import annotations

import math

import torch

from .reference import box_wave, gll

__all__ = ["make", "DTYPES"]

DTYPES = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}


def _grid_axes(config: dict) -> list[torch.Tensor]:
    """Dof coordinates of the box along each axis (float64, host)."""
    h = box_wave.cell_sizes(config)
    return [torch.tensor(gll.dof_coords(n, config["degree"], h[d]), dtype=torch.float64)
            for d, n in enumerate(config["cells"])]


def make(config: dict, spec: dict, seed: int, device) -> list[dict]:
    """``spec["count"]`` inputs of kind ``spec["kind"]`` from ``seed``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (2 ** 63))
    dtype = DTYPES[spec.get("dtype", "f32")]
    axes = [a.to(dev) for a in _grid_axes(config)]
    shape = tuple(len(a) for a in axes)
    out = []
    for _ in range(spec["count"]):
        if spec["kind"] == "normal":
            b = torch.randn(shape, generator=gen, device=dev, dtype=torch.float64)
            out.append({"b": b.to(dtype)})
        elif spec["kind"] == "smooth_modes":
            w0 = 2.0 * math.pi * config["f0"]
            scale = {"u": spec["u_scale"] * config["p0"],
                     "v": spec["v_scale"] * config["p0"] * w0}
            out.append({k: _modes(axes, spec, gen, s).to(dtype) for k, s in scale.items()})
        else:
            raise ValueError(f"input kind {spec['kind']!r}: smooth_modes or normal")
    return out


def _modes(axes, spec, gen, scale) -> torch.Tensor:
    dev = axes[0].device
    m = spec["modes"]
    k = [torch.randint(0, kmax + 1, (m,), generator=gen, device=dev)
         for kmax in spec["max_wavenumber"]]
    amp = (torch.rand(m, generator=gen, device=dev, dtype=torch.float64) * 2 - 1) * scale
    phase = torch.rand(m, generator=gen, device=dev, dtype=torch.float64) * 2 * math.pi
    ext = [a[-1] for a in axes]
    f = torch.zeros(tuple(len(a) for a in axes), dtype=torch.float64, device=dev)
    for i in range(m):
        cx = torch.cos(math.pi * k[0][i] * axes[0] / ext[0] + phase[i])
        cy = torch.cos(math.pi * k[1][i] * axes[1] / ext[1])
        cz = torch.cos(math.pi * k[2][i] * axes[2] / ext[2])
        f += amp[i] * cx[:, None, None] * cy[None, :, None] * cz[None, None, :]
    return f
