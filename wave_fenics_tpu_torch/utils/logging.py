"""Structured logging: the loguru/LOG(INFO) analogue.

Port of ``wave_fenics_tpu.utils.logging``: a logger, the reference's
step-counter progress line (LinearGLL.hpp:272-278), and a device summary
(the output_device_info analogue, common/cuda/utils.hpp:40-56) from
``torch.cuda``'s device properties.
"""

from __future__ import annotations

import logging
import sys

import torch

__all__ = ["get_logger", "progress", "device_info"]

_FMT = "[%(asctime)s %(name)s] %(levelname)s %(message)s"


def get_logger(name: str = "wave_fenics_tpu_torch") -> logging.Logger:
    log = logging.getLogger(name)
    if not log.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FMT, datefmt="%H:%M:%S"))
        log.addHandler(h)
        log.setLevel(logging.INFO)
    return log


def progress(step: int, nstep: int, t: float, every: int = 50) -> None:
    """Progress line every ``every`` steps (LinearGLL.hpp:272-278)."""
    if step % every == 0:
        get_logger().info("t: %.6e,\t Steps: %d/%d", t, step, nstep)


def device_info() -> str:
    """One line per CUDA device, or a note that there is none."""
    if not torch.cuda.is_available():
        return "no CUDA device"
    lines = []
    for i in range(torch.cuda.device_count()):
        pr = torch.cuda.get_device_properties(i)
        lines.append(
            f"{i}: {pr.name} sm_{pr.major}{pr.minor} "
            f"SMs={pr.multi_processor_count} mem={pr.total_memory / 2**30:.1f}GiB"
        )
    return "\n".join(lines)
