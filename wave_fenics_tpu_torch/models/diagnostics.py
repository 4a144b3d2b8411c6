"""Physics diagnostics of wave solves.

Port of ``wave_fenics_tpu.models.diagnostics``. The reference prints only
step counters and the solve time (SURVEY.md §5); these are the standard
observables that validate a wave solver:

- the acoustic energy E(t) = 1/2 [ <v, M v> / c0^2 + <u, K u> ]
  (conserved by the continuous system on a closed domain; it decays
  through absorbing boundaries);
- the L2 norm of a field through the mass inner product.

Both run on the model's operators, so on the model's device: on a card a
structured model's stiffness is kernel F and a general model's mass and
stiffness are kernel K.
"""

from __future__ import annotations

import torch

__all__ = ["energy", "l2_norm"]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def energy(model, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Total acoustic energy of the (u, v) state, a 0-d tensor on the
    state's device. Works for any model with ``ops.mass``,
    ``ops.stiffness`` and ``c0`` (``LinearWave`` grids and
    ``GeneralLinearWave`` flat vectors alike)."""
    ops = model.ops
    kin = _dot(v, ops.mass(v)) / model.c0**2
    # ops.stiffness returns -c0^2 K u; undo the sign and scale for <u, K u>
    pot = -_dot(u, ops.stiffness(u, 1.0))
    return 0.5 * (kin + pot)


def l2_norm(model, u: torch.Tensor) -> torch.Tensor:
    """||u||_{L2} = sqrt(<u, M u>) (mass-weighted, mesh-independent)."""
    return torch.sqrt(_dot(u, model.ops.mass(u)))
