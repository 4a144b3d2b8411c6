"""The yardstick of the roofline shares: the card's published peaks, and
the operations and bytes of one unit of a cell's work, counted from the
problem alone (cells, p, Gauss points, the state's type and the scheme's
fields; nothing of the port's padding, tiles or launches).

Operations: the configuration names its operator (``operator``), and
``operators/<operator>.py`` gives the operations of one sum-factorised
apply a cell, ``cell_flops(degree, config)``, with its derivation; an
apply on the mesh costs that times the cells.

Bytes: each field that the scheme carries across a unit of work read
once and written once, plus each extra vector the unit reads or writes
once (CG's matvec: its input read, its output written), at the state's
item size, on the unpadded dof grid.

A traffic file's ``roofline`` object names the unit (``per``), the
applies a unit (``applies``), the fields carried (``fields``) and the
extra vector transfers (``extra_vectors``).
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

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


#: the operators' counts, a file each, found by the configuration's name
OPERATORS = Path(__file__).resolve().parent / "operators"


def apply_flops(config: dict) -> int:
    """Operations of one sum-factorised apply of the configuration's
    operator on its cells (``operators/<operator>.py``)."""
    path = OPERATORS / f"{config['operator']}.py"
    if not path.is_file():
        raise ValueError(f"operator {config['operator']!r}: no file {path}; add one that "
                         "defines cell_flops(degree, config)")
    spec = importlib.util.spec_from_file_location(f"port_bench_operator_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return math.prod(config["cells"]) * mod.cell_flops(config["degree"], config)


def unit_work(config: dict, traffic: dict) -> tuple[int, int]:
    """(operations, bytes) of one unit of the cell's work."""
    r = traffic["roofline"]
    flops = r["applies"] * apply_flops(config)
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
