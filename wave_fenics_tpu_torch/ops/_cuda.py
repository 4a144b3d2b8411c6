"""Build the hand-written CUDA kernels of ``csrc/`` and bind them with ctypes.

At first use, ``nvcc`` compiles ``csrc/*.cu`` for ``sm_90a`` into a shared
library with a plain C interface, under ``_build/<hash>/`` (the hash covers
the sources and the flags, so an edited source builds anew), and ctypes
loads it. Nothing here runs when the module is imported, so the package
imports and its CPU tests run on a machine without ``nvcc`` or a card.

Each launcher returns ``cudaGetLastError()`` after its launch; :func:`launch`
raises on anything but success. Launches go to PyTorch's current stream on
the tensors' device and do not synchronise.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

__all__ = ["KernelLibrary", "library", "launch", "check_operands", "nvcc"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# cvx, sx, fx, cvy, cvz, p, Lx, Ly, Lz, x0, nx, h, ny, nz
_STENCIL = [_P] * 5 + [_I] * 9
_SIGNATURES = {
    # x, y, <stencil>, stream
    "wave_apply_flat": [_P, _P] + _STENCIL + [_P],
    # stage, u0, v0, kv0, kv1, kv2, kv_out, u1, v1, w1, w2, src_x, abc_x,
    # dt, g, c0, <stencil>, stream
    "wave_rk4_stage": [_I] + [_P] * 10 + [_I, _I, _D, _D, _D] + _STENCIL + [_P],
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


@dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    #: nvcc's output (ptxas register/spill report) from the build
    build_log: str
    #: seconds spent compiling in this process (0 when the cache held it)
    build_seconds: float


def nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    cands = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(Path(os.environ[var]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels of wave_fenics_tpu_torch build from source at first use"
    )


def _build(sources: list[Path], out_dir: Path) -> tuple[Path, str, float]:
    so = out_dir / "libwave_kernels.so"
    log = out_dir / "build.log"
    if so.is_file():
        return so, log.read_text() if log.is_file() else "", 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libwave_kernels.{os.getpid()}.so"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sources if s.suffix == ".cu"]]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    text = f"$ {' '.join(cmd)}\n{res.stdout}{res.stderr}"
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {res.returncode}:\n{text}")
    log.write_text(text)
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so, text, seconds


@functools.cache
def library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library."""
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    so, text, seconds = _build(sources, BUILD_DIR / h.hexdigest()[:16])
    lib = ctypes.CDLL(str(so))
    for base, argtypes in _SIGNATURES.items():
        for suffix in _SUFFIX.values():
            fn = getattr(lib, f"{base}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.wave_error_string.argtypes = [ctypes.c_int]
    lib.wave_error_string.restype = ctypes.c_char_p
    return KernelLibrary(lib=lib, path=so, build_log=text, build_seconds=seconds)


def check_operands(device: torch.device, dtype: torch.dtype, **operands) -> None:
    """Raise unless every ``name=(tensor, shape)`` is a contiguous tensor of
    ``dtype`` and ``shape`` on the CUDA ``device``."""
    if device.type != "cuda":
        raise ValueError(f"CUDA kernel called with a tensor on {device}")
    if dtype not in _SUFFIX:
        raise TypeError(f"CUDA kernels take float32 or float64, not {dtype}")
    for name, (t, shape) in operands.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def launch(name: str, dtype: torch.dtype, device: torch.device, *args) -> None:
    """Call launcher ``name`` (f32/f64 by ``dtype``) on ``device``'s current
    stream; tensors among ``args`` pass as their data pointers."""
    kl = library()
    fn = getattr(kl.lib, f"{name}_{_SUFFIX[dtype]}")
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*conv, stream)
    if rc != 0:
        msg = kl.lib.wave_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
