"""Typed configuration of a planar3d run.

Port of ``wave_fenics_tpu.utils.config``: the same dataclasses, field names
and defaults, and the same JSON form, so a config file written by the JAX
package loads here unchanged. ``build_case`` builds the case on a device
(the card unless the caller asks for the CPU): the box case through
``planar3d_case``, or, with ``domain.mesh_path`` (and
``domain.meshtags_path``), the imported-mesh case through
``planar3d_case_xdmf``, where ``ncells``, ``domain_length`` and ``width``
are ignored as the JAX package ignores them. ``run.output_path`` names the
XDMF file of the final state (``apps/planar3d_app.py``).
``run.force_padded`` is accepted and has no effect: the port's app always
runs the padded solvers on a box.

``run.ndev > 1`` runs the box on that many blocks, and an imported mesh
on that many RCB parts of its cells (the app's sharded branch,
``parallel/sharded_padded.py``, ``parallel/sharded_general.py``).

Fields the port cannot honour yet raise a ValueError naming what is
missing, and are never silently ignored. ``run.dtype == 'bf16'`` (bf16
state) runs every path of the box on one device (kernels A to F, H, I and
J); with an imported mesh or ``run.ndev > 1`` it raises, naming bf16 and
the kernel or path it lacks.

The JAX package's box case ignores ``physics.window_periods``,
``time.t0``, ``domain.source_tag``, ``domain.abc_tag`` and
``run.log_every_steps`` (its imported-mesh case honours the two tags);
honouring them would make the port disagree with the reference on the
same file, so where the JAX package ignores a field a value other than the
default raises a ValueError that names the field.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field

import torch

__all__ = ["PhysicsConfig", "DomainConfig", "TimeConfig", "RunConfig",
           "SimulationConfig", "DTYPES"]

#: the state dtypes the port runs (``run.dtype``; bf16 on the box on one
#: device only, ``SimulationConfig.check_supported``)
DTYPES = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}


@dataclass
class PhysicsConfig:
    speed_of_sound: float = 1500.0       # c0 (m/s)
    source_frequency: float = 0.5e6      # f0 (Hz)
    pressure_amplitude: float = 60000.0  # p0 (Pa)
    window_periods: float = 4.0          # source ramp length (alpha)


@dataclass
class DomainConfig:
    ncells: tuple[int, int, int] = (64, 32, 32)
    domain_length: float = 0.1           # L (m)
    width: float | None = None           # transverse width (defaults cubic cells)
    degree: int = 4                      # basis degree p
    source_tag: int = 1
    abc_tag: int = 2
    #: imported-mesh mode (the reference's planar3d workflow,
    #: demo/cpu_planar3d/main.cpp:39-45): an XDMF mesh and its facet
    #: meshtags; ``ncells``/``domain_length``/``width`` are then ignored and
    #: the model is the explicit-dofmap GeneralLinearWave
    mesh_path: str | None = None
    meshtags_path: str | None = None


@dataclass
class TimeConfig:
    cfl: float = 0.5
    n_tail_periods: float = 8.0
    t0: float = 0.0
    #: 'rk4' or 'leapfrog' (2nd order, one stiffness apply per step; dt
    #: scaled by 0.71 in the app)
    integrator: str = "rk4"


@dataclass
class RunConfig:
    dtype: str = "f32"                   # f32 | f64 | bf16 (the box, one device)
    ndev: int = 1                        # > 1: blocks, or RCB parts of a mesh
    checkpoint_dir: str | None = None
    checkpoint_every_steps: int = 1000
    log_every_steps: int = 50
    #: write the final u/v as XDMF (a rectilinear grid for a box, the
    #: p-refined sub-hex grid for an imported mesh), binary heavy data
    output_path: str | None = None
    #: accepted, no effect: the port's app always runs the padded solvers
    force_padded: bool = False


@dataclass
class SimulationConfig:
    physics: PhysicsConfig = field(default_factory=PhysicsConfig)
    domain: DomainConfig = field(default_factory=DomainConfig)
    time: TimeConfig = field(default_factory=TimeConfig)
    run: RunConfig = field(default_factory=RunConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "SimulationConfig":
        d = json.loads(s)
        return cls(
            physics=PhysicsConfig(**d.get("physics", {})),
            domain=DomainConfig(**{
                **d.get("domain", {}),
                "ncells": tuple(d.get("domain", {}).get("ncells", (64, 32, 32))),
            }),
            time=TimeConfig(**d.get("time", {})),
            run=RunConfig(**d.get("run", {})),
        )

    def check_supported(self) -> None:
        """Raise a ValueError for the first field the port cannot honour."""
        d, r = self.domain, self.run
        imported = d.mesh_path is not None
        ignored = [("physics.window_periods", self.physics.window_periods, 4.0),
                   ("time.t0", self.time.t0, 0.0),
                   ("run.log_every_steps", r.log_every_steps, 50)]
        if not imported:  # the JAX package honours the tags on imported meshes
            ignored += [("domain.source_tag", d.source_tag, 1),
                        ("domain.abc_tag", d.abc_tag, 2)]
        for name, value, default in ignored:
            if value != default:
                raise ValueError(
                    f"{name} = {value!r}: the case is built with its default "
                    f"{default!r}, as the JAX package builds it; other values "
                    "are not supported")
        if d.meshtags_path is not None and not imported:
            raise ValueError("domain.meshtags_path needs domain.mesh_path: facet "
                             "tags belong to an imported mesh")
        if r.ndev < 1:
            raise ValueError(f"run.ndev = {r.ndev}: at least 1")
        if r.dtype not in DTYPES:
            raise ValueError(f"run.dtype = {r.dtype!r}: f32, f64 or bf16")
        if self.time.integrator not in ("rk4", "leapfrog"):
            raise ValueError(f"time.integrator = {self.time.integrator!r}: "
                             "rk4 or leapfrog")

    def build_case(self, device: torch.device | str = "cuda"):
        """The Planar3DCase of this config, its model on ``device``."""
        from ..models.planar3d import planar3d_case, planar3d_case_xdmf

        self.check_supported()
        if self.domain.mesh_path is not None:
            return planar3d_case_xdmf(
                self.domain.mesh_path,
                self.domain.meshtags_path,
                degree=self.domain.degree,
                speed_of_sound=self.physics.speed_of_sound,
                source_frequency=self.physics.source_frequency,
                pressure_amplitude=self.physics.pressure_amplitude,
                cfl=self.time.cfl,
                n_tail_periods=self.time.n_tail_periods,
                source_tag=self.domain.source_tag,
                abc_tag=self.domain.abc_tag,
                dtype=DTYPES[self.run.dtype],
                device=device,
            )
        return planar3d_case(
            ncells=tuple(self.domain.ncells),
            domain_length=self.domain.domain_length,
            width=self.domain.width,
            degree=self.domain.degree,
            speed_of_sound=self.physics.speed_of_sound,
            source_frequency=self.physics.source_frequency,
            pressure_amplitude=self.physics.pressure_amplitude,
            cfl=self.time.cfl,
            n_tail_periods=self.time.n_tail_periods,
            dtype=DTYPES[self.run.dtype],
            device=device,
        )
