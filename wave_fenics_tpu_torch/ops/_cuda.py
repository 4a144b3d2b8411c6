"""Build the hand-written CUDA kernels of ``csrc/`` and bind them with ctypes.

At first use, ``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` (one
process per source, all started together) and links the objects into a
shared library with a plain C interface, under ``_build/<hash>/`` (the hash
covers the sources and the flags, so an edited source builds anew); ctypes
loads it. Nothing here runs when the module is imported, so the package
imports and its CPU tests run on a machine without ``nvcc`` or a card.

Every launcher of a kernel of the solvers has an f32, an f64 and a bf16
instantiation; the set-up kernels of ``native.py`` have one type each.
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

__all__ = ["KernelLibrary", "library", "load", "launch", "launcher", "check_operands",
           "check_index_operands", "check_typed_operands", "check_no_alias", "nvcc"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _D, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_int64
# cvx, sx, fx, cvy, cvz, p, Lx, Ly, Lz, x0, nx, h, ny, nz
_STENCIL = [_P] * 5 + [_I] * 9
_SIGNATURES = {
    # x, y, <stencil>, ty, tz, cx, gx, gy, gz, smem, stream (kernel B; the
    # tiling of ops/tiling.py::tma_geometry)
    "wave_apply_flat_tiled": [_P, _P] + _STENCIL + [_I] * 7 + [_P],
    # stage, u0, v0, kv0, kv1, kv2, kv_out, u1, v1, w1, w2, src_x, abc_x,
    # dt, g, c0, <stencil>, ty, tz, cx, gx, gy, gz, smem, padding_first,
    # stream (lean: kernel A; full tableau: kernel C; the tiling of
    # ops/rk4step.py::stage_geometry and tma_padding_first)
    "wave_rk4_stage": [_I] + [_P] * 10 + [_I, _I, _D, _D, _D] + _STENCIL + [_I] * 8 + [_P],
    "wave_rk4_full_stage": [_I] + [_P] * 10 + [_I, _I, _D, _D, _D] + _STENCIL + [_I] * 8 + [_P],
    # u0, v0, kv0, kv1, kv2, u1, v1, kv0_out, w1, w2, src_x, abc_x, dt, g,
    # c0, <stencil>, ty, tz, cx, gx, gy, gz, smem, stream (kernel J's step
    # boundary; ops/rk42step.py::boundary_launch_args)
    "wave_rk42_boundary_tiled": [_P] * 10 + [_I, _I, _D, _D, _D] + _STENCIL
    + [_I] * 7 + [_P],
    # x, y, lyz, lxz, lxy, cvx, cvy, cvz, p, Lx, Ly, Lz, x0, nx, h, ny, nz,
    # ty, tz, cx, gx, gy, gz, smem, stream (kernel E; the tiling of
    # ops/tiling.py::tma_geometry)
    "wave_apply_slab_tiled": [_P] * 8 + [_I] * 9 + [_I] * 7 + [_P],
    # u0, ku, v0, kv, ua, va, vn_out, kv_out, ua_out, va_out, w1, w2,
    # src_x, abc_x, ca, cb, g, c0, <stencil>, ty, tz, cx, gx, gy, gz, smem,
    # stream (kernel D)
    "wave_rk_stage_tiled": [_P] * 12 + [_I, _I, _D, _D, _D, _D] + _STENCIL
    + [_I] * 7 + [_P],
    # phase, u, v, u_out, v_out, w1, w2, src_x, abc_x, dt, g, c0, <stencil>,
    # ty, tz, cx, gx, gy, gz, smem, padding_first, stream (kernels H and I;
    # the tiling of ops/tiling.py::tma_geometry and tma_padding_first)
    "wave_lf_phase_tiled": [_I] + [_P] * 6 + [_I, _I, _D, _D, _D] + _STENCIL
    + [_I] * 8 + [_P],
    # x, y, cvx, cvy, cvz, lx, ly, lz, p, Nx, Ny, Nz, ty, tz, cx, gx, gy, gz,
    # smem, stream (kernel F; the tiling of ops/tiling.py::grid_geometry)
    "wave_stiffness_tiled": [_P] * 8 + [_I] * 4 + [_I] * 7 + [_P],
    # x, y, cvx, cvy, cvz, p, Lx, Ly, Lz, x0, nx, h, ny, nz, ty, tz, cx, gx,
    # gy, gz, smem, stream (kernel G; ops/mass.py::mass_launch_args)
    "wave_mass_tiled": [_P] * 5 + [_I] * 9 + [_I] * 7 + [_P],
    # x, y, work (y, or bf16's float32 accumulator), dofmap, cells,
    # colour_starts (host), ncolours, B, D, geo, w, mode, affine, m, nq, nc,
    # ndofs, cpb, stride, smem, coeff, stream (kernel K)
    "wave_general_apply": [_P] * 6 + [_I] + [_P] * 4 + [_I] * 9 + [_D, _P],
}
#: launchers with one type only (no _f32/_f64 pair): the set-up kernels of
#: csrc/setup_kernels.cu (native.py), float64 coordinates and int64 keys
_SETUP_SIGNATURES = {
    # X, dphi, w, nc, nq, qt, cb, clamp, G, detJw, singular, smem, stream
    "wave_geometry_factors": [_P] * 3 + [_L] + [_I] * 4 + [_P] * 3 + [_I, _P],
    # X, phi, nc, nd, inv, keys, coords, stream
    "wave_node_keys": [_P, _P, _L, _I, _D, _P, _P, _P],
    # keys, n, table, mask, rep, overflow, stream
    "wave_dedup_hash": [_P, _L, _P, ctypes.c_uint64, _P, _P, _P],
}
#: every launcher of _SIGNATURES has these three instantiations (bf16: bf16
#: state and tables, float32 arithmetic)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}


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


def _driver_link_flags(exe: str) -> list[str]:
    """Link flags for the CUDA driver library (the TMA kernels build their
    tensor maps with ``cuTensorMapEncodeTiled``): ``-lcuda``, with the
    toolkit's stub directory searched first where it has one."""
    stubs = Path(exe).resolve().parent.parent / "lib64" / "stubs"
    return ([f"-L{stubs}"] if stubs.is_dir() else []) + ["-lcuda"]


def _build(sources: list[Path], out_dir: Path) -> tuple[Path, str, float]:
    so = out_dir / "libwave_kernels.so"
    log = out_dir / "build.log"
    if so.is_file():
        return so, log.read_text() if log.is_file() else "", 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    tmp = out_dir / f"libwave_kernels.{tag}.so"
    exe = nvcc()
    t0 = time.perf_counter()
    # one nvcc per source, all at once; then one link
    cmds = [[exe, *NVCC_FLAGS, "-c", "-o", str(out_dir / f"{s.stem}.{tag}.o"),
             str(s)] for s in sources if s.suffix == ".cu"]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    cmds.append([exe, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp),
                 *(c[c.index("-o") + 1] for c in cmds), *_driver_link_flags(exe)])
    text = "".join(f"$ {' '.join(c)}\n{o}" for c, o in zip(cmds, outs))
    failed = [proc.returncode for proc in procs if proc.returncode != 0]
    if not failed:
        res = subprocess.run(cmds[-1], capture_output=True, text=True)
        text += f"$ {' '.join(cmds[-1])}\n{res.stdout}{res.stderr}"
        failed = [res.returncode] if res.returncode != 0 else []
    seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError(f"nvcc failed with exit code {failed[0]}:\n{text}")
    log.write_text(text)
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so, text, seconds


@functools.cache
def library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library of ``csrc/``."""
    return load(CSRC)


def load(csrc: Path) -> KernelLibrary:
    """Build (once per source hash, under ``_build/``) and load the kernel
    library of the ``*.cu`` and ``*.cuh`` sources in directory ``csrc``."""
    sources = sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))
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
    for name, argtypes in _SETUP_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.wave_error_string.argtypes = [ctypes.c_int]
    lib.wave_error_string.restype = ctypes.c_char_p
    return KernelLibrary(lib=lib, path=so, build_log=text, build_seconds=seconds)


def check_no_alias(written, read=()) -> None:
    """Raise unless the tensors in ``written`` are pairwise distinct and
    none of them is one of the tensors in ``read``."""
    w = [t.data_ptr() for t in written]
    if len(set(w)) != len(w) or set(w) & {t.data_ptr() for t in read}:
        raise ValueError("the outputs and the scratch must not alias each "
                         "other or the inputs")


def check_operands(device: torch.device, dtype: torch.dtype, **operands) -> None:
    """Raise unless every ``name=(tensor, shape)`` is a contiguous tensor of
    ``dtype`` and ``shape`` on the CUDA ``device``."""
    if device.type != "cuda":
        raise ValueError(f"CUDA kernel called with a tensor on {device}")
    if dtype not in _SUFFIX:
        raise TypeError(f"CUDA kernels take float32, float64 or bfloat16, not {dtype}")
    _check_tensors(device, dtype, operands)


def check_typed_operands(device: torch.device, dtype: torch.dtype, **operands) -> None:
    """Raise unless every ``name=(tensor, shape)`` is a contiguous tensor of
    exactly ``dtype`` and ``shape`` on the CUDA ``device`` (the one-type
    launchers of ``_SETUP_SIGNATURES``)."""
    if device.type != "cuda":
        raise ValueError(f"CUDA kernel called with a tensor on {device}")
    _check_tensors(device, dtype, operands)


def check_index_operands(device: torch.device, **operands) -> None:
    """Raise unless every ``name=(tensor, shape)`` is a contiguous int32
    tensor of ``shape`` on ``device`` (index tables)."""
    _check_tensors(device, torch.int32, operands)


def _check_tensors(device, dtype, operands) -> None:
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


def launch(name: str, dtype: torch.dtype | None, device: torch.device, *args) -> None:
    """Call launcher ``name`` (f32/f64/bf16 by ``dtype``; ``None`` for a launcher
    of one type only, ``_SETUP_SIGNATURES``) on ``device``'s current
    stream; tensors among ``args`` pass as their data pointers."""
    launcher(library(), name, dtype, device, *args)()


def launcher(kl: KernelLibrary, name: str, dtype: torch.dtype | None,
             device: torch.device, *args):
    """A callable that launches ``name`` of library ``kl`` on ``args`` as
    :func:`launch` does, with the arguments and the stream converted once:
    it costs the host little more than the ctypes call, so back-to-back
    calls time the kernel itself."""
    if (dtype is None) != (name in _SETUP_SIGNATURES):
        raise TypeError(f"{name}: {'one type only' if dtype is not None else 'a type'} "
                        "(the set-up kernels take dtype None, every other "
                        "launcher float32, float64 or bfloat16)")
    fn = getattr(kl.lib, name if dtype is None else f"{name}_{_SUFFIX[dtype]}")
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream(device).cuda_stream

    def call() -> None:
        with torch.cuda.device(device):
            rc = fn(*conv, stream)
        if rc != 0:
            msg = kl.lib.wave_error_string(rc).decode()
            raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")

    return call
