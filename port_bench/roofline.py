"""The yardstick of the roofline shares: the card's published peaks, and
the operations and bytes of one unit of a cell's work, counted from the
problem alone (cells, p, Gauss points, the state's type and the scheme's
fields; nothing of the port's padding, tiles or launches).

Operations (sum-factorised applies on a box, a multiply-add counted as
two operations; m = p + 1 nodes, nq Gauss points a direction):

- GLL-collocated stiffness on a box of axis-aligned cells
  (``stiffness_gll_box``), a cell: there the stiffness is a sum over the
  axes of the 1D stiffness D^T W D / h along one axis times the GLL
  weights of the other two, which are diagonal. So an axis costs one
  precomputed 1D product (2 m^4) and the other two axes' weights as one
  scaling (m^3); then the sum over the axes (2 m^3) and the assembly add
  (m^3): 6 m^4 + 6 m^3. A general hex, with its three derivatives and
  their transposes applied apart, costs about twice that: another
  operator.
- Gauss mass, a cell: interpolation to the Gauss points, x then y then z
  (2 nq m^3, 2 nq^2 m^2, 2 nq^3 m), the quadrature weight (nq^3), the
  transposed interpolation (the same three) and the assembly add (m^3):
  4 (nq m^3 + nq^2 m^2 + nq^3 m) + nq^3 + m^3.

Bytes: each field that the scheme carries across a unit of work read
once and written once, plus each extra vector the unit reads or writes
once (CG's matvec: its input read, its output written), at the state's
item size, on the unpadded dof grid.

A traffic file's ``roofline`` object names the unit (``per``), the
applies a unit (``applies``), the fields carried (``fields``) and the
extra vector transfers (``extra_vectors``); the configuration names the
operator (``operator``).
"""

from __future__ import annotations

import math

__all__ = ["PEAKS", "peaks", "ndofs", "apply_flops", "unit_work", "least_time_s", "share_pct"]

#: published dense peaks of the card (NVIDIA H100 SXM data sheet, at its
#: 700 W limit): float32 outside the tensor cores, and HBM3 bandwidth.
#: A bf16 state runs float32 arithmetic in the port's kernels.
PEAKS = {
    "NVIDIA H100": {"flops": {"f32": 67e12, "bf16": 67e12, "f64": 34e12},
                    "bytes_per_s": 3.35e12},
}

ITEM_BYTES = {"f32": 4, "bf16": 2, "f64": 8}


def peaks(device_kind: str) -> dict | None:
    """The peaks of the card named ``device_kind`` (its name begins with a
    key of ``PEAKS``), or None for a card the table does not hold."""
    for key, value in PEAKS.items():
        if device_kind.startswith(key):
            return value
    return None


def ndofs(cells, degree: int) -> int:
    return math.prod(n * degree + 1 for n in cells)


def apply_flops(operator: str, cells, degree: int, gauss_points: int | None = None) -> int:
    """Operations of one sum-factorised apply of ``operator`` on the box."""
    m = degree + 1
    if operator == "stiffness_gll_box":
        per_cell = 6 * m ** 4 + 6 * m ** 3
    elif operator == "mass_gauss":
        q = gauss_points
        per_cell = 4 * (q * m ** 3 + q ** 2 * m ** 2 + q ** 3 * m) + q ** 3 + m ** 3
    else:
        raise ValueError(f"operator {operator!r}: stiffness_gll_box or mass_gauss")
    return math.prod(cells) * per_cell


def unit_work(config: dict, traffic: dict) -> tuple[int, int]:
    """(operations, bytes) of one unit of the cell's work."""
    r = traffic["roofline"]
    flops = r["applies"] * apply_flops(config["operator"], config["cells"],
                                       config["degree"], config.get("gauss_points"))
    words = 2 * r["fields"] + r.get("extra_vectors", 0)
    return flops, words * ndofs(config["cells"], config["degree"]) * ITEM_BYTES[config["dtype"]]


def least_time_s(config: dict, traffic: dict, device_kind: str) -> float | None:
    """The least time one unit of work takes on the card at its peaks."""
    pk = peaks(device_kind)
    if pk is None:
        return None
    flops, nbytes = unit_work(config, traffic)
    return max(flops / pk["flops"][config["dtype"]], nbytes / pk["bytes_per_s"])


def share_pct(run, per: str) -> float | None:
    """The least time of the traced units of work over the device's busy
    time in the traced solves, in percent; None without a trace that saw
    kernels, on a card the table does not hold, or for a cell whose unit
    of work is not ``per``."""
    t = run.trace
    if run.per != per or t is None or t.busy_s <= 0 or not t.kernels:
        return None
    least = least_time_s(run.config, run.traffic, run.device_kind)
    return None if least is None else 100.0 * least * t.units / t.busy_s
