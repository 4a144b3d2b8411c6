"""The 3D planar HIFU benchmark case: the reference's north-star workload.

Port of ``wave_fenics_tpu.models.planar3d`` (box case). Mirrors
demo/cpu_planar3d/main.cpp:
- material/source/domain constants (:24-36): c0 = 1500 m/s, f0 = 0.5 MHz,
  p0 = 60 kPa, L = 0.1 m, basis degree 4
- CFL timestep dt = CFL * hmin / (c0 * p^2), snapped to an integer number of
  steps per source period (:61-66)
- final time tf = L/c0 + 8/f0 (:64)
- boundary tags: source plane at x = 0 (ds(1)), absorbing plane at x = L
  (ds(2)).

``planar3d_case`` builds the case on a box; ``planar3d_case_xdmf`` on an
imported XDMF mesh and its facet meshtags (main.cpp:39-45), as a
``GeneralLinearWave``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core.mesh import FacetTags, box_mesh
from .general_wave import GeneralLinearWave, read_mesh_and_tags
from .linear_wave import LinearWave

__all__ = ["Planar3DCase", "planar3d_case", "planar3d_case_xdmf", "general_case",
           "analytic_plane_wave"]


@dataclass(frozen=True)
class Planar3DCase:
    model: LinearWave | GeneralLinearWave
    t0: float
    tf: float
    dt: float
    steps_per_period: int
    #: host seconds spent reading the mesh files (imported meshes only)
    read_seconds: float = 0.0

    @property
    def nsteps(self) -> int:
        return int((self.tf - self.t0) / self.dt) + 1


def planar3d_case(
    ncells: tuple[int, int, int] = (64, 4, 4),
    domain_length: float = 0.1,
    width: float | None = None,
    degree: int = 4,
    speed_of_sound: float = 1500.0,
    source_frequency: float = 0.5e6,
    pressure_amplitude: float = 60000.0,
    cfl: float = 0.5,
    n_tail_periods: float = 8.0,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
) -> Planar3DCase:
    """Build the planar3d case (demo/cpu_planar3d/main.cpp:24-72 semantics)
    with its model on ``device`` (the card unless the caller asks for the
    CPU)."""
    L = domain_length
    if width is None:
        width = L * ncells[1] / ncells[0]  # keep cells cubic by default
    tags = FacetTags({1: (0,), 2: (1,)})  # x=lo -> source, x=hi -> absorbing
    mesh = box_mesh(ncells, (L, width, width), facet_tags=tags)

    model = LinearWave(
        mesh=mesh,
        p=degree,
        c0=speed_of_sound,
        freq0=source_frequency,
        p0=pressure_amplitude,
        dtype=dtype,
        device=device,
    )

    # CFL timestep snapped to integer steps per period (main.cpp:61-66)
    h = mesh.hmin()
    dt = cfl * h / (speed_of_sound * degree**2)
    period = 1.0 / source_frequency
    steps_per_period = int(period / dt) + 1
    dt = period / steps_per_period

    t0 = 0.0
    tf = L / speed_of_sound + n_tail_periods / source_frequency
    return Planar3DCase(
        model=model, t0=t0, tf=tf, dt=dt, steps_per_period=steps_per_period
    )


def planar3d_case_xdmf(
    mesh_path: str,
    meshtags_path: str | None = None,
    degree: int = 4,
    speed_of_sound: float = 1500.0,
    source_frequency: float = 0.5e6,
    pressure_amplitude: float = 60000.0,
    cfl: float = 0.5,
    n_tail_periods: float = 8.0,
    source_tag: int = 1,
    abc_tag: int = 2,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
    quadrature: str = "gll",
) -> Planar3DCase:
    """The planar3d case on an imported mesh, the reference's own workflow
    (demo/cpu_planar3d/main.cpp:39-45 reads the mesh and its facet meshtags
    from XDMF; ds(1) = source, ds(2) = absorbing). The model is the
    explicit-dofmap ``GeneralLinearWave`` on ``device`` (kernel K on a
    card); dt takes the box case's CFL snap (main.cpp:61-66) with hmin
    measured on the imported geometry, and tf = Lx/c0 + tail with Lx the
    mesh's x-extent (main.cpp:64)."""
    tr = time.perf_counter()
    mesh, facet_tags = read_mesh_and_tags(mesh_path, meshtags_path)
    read_s = time.perf_counter() - tr
    return general_case(GeneralLinearWave(
        mesh=mesh,
        p=degree,
        facet_tags=facet_tags,
        c0=speed_of_sound,
        freq0=source_frequency,
        p0=pressure_amplitude,
        source_tag=source_tag,
        abc_tag=abc_tag,
        dtype=dtype,
        device=device,
        quadrature=quadrature,
    ), cfl, n_tail_periods, read_s)


def general_case(model: GeneralLinearWave, cfl: float = 0.5, n_tail_periods: float = 8.0,
                 read_seconds: float = 0.0) -> Planar3DCase:
    """The planar3d case of a general model: the box case's CFL snap
    (main.cpp:61-66) with hmin measured on its mesh, and tf = Lx/c0 + tail
    with Lx the mesh's x-extent (main.cpp:64)."""
    mesh = model.mesh
    h = mesh.hmin()
    dt = cfl * h / (model.c0 * model.p**2)
    period = 1.0 / model.freq0
    steps_per_period = int(period / dt) + 1
    dt = period / steps_per_period

    xs = np.asarray(mesh.points)[:, 0]
    L = float(xs.max() - xs.min())
    t0 = 0.0
    tf = L / model.c0 + n_tail_periods / model.freq0
    return Planar3DCase(
        model=model, t0=t0, tf=tf, dt=dt, steps_per_period=steps_per_period,
        read_seconds=read_seconds,
    )


def analytic_plane_wave(x: np.ndarray, t: float, case: Planar3DCase) -> np.ndarray:
    """Steady-state analytic solution of the 1D planar problem: after the
    source window has ramped (t > alpha*T) and the wavefront has passed x,
    u(x, t) = p0 * sin(w0 (t - x/c0))."""
    m = case.model
    tau = t - x / m.c0
    return m.p0 * np.sin(m.w0 * tau) * (tau > 0)
