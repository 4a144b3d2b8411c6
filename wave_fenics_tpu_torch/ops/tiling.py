"""The launch tilings of the tiled stencil kernels (csrc/stencil_tiled.cuh).

A tile block owns TY x TZ interior (y, z) columns, one thread each, and
streams CX interior x rows plus p warm-up planes on each side; the grid is
(z tiles, y tiles, x-chunks). Two families share the policy:

- :func:`grid_geometry`: kernel F (``csrc/stiffness_tiled.cu``), whose
  planes arrive by ``cp.async`` into a ring of PIPE planes, one field a
  plane on the unpadded dof grid;
- :func:`tma_geometry`: kernels A and C and kernel J's stages
  (``csrc/rk4_tiled.cu``, through ``ops/rk4step.py::stage_geometry``), B
  (``csrc/flat_tiled.cu``), D (``csrc/rk_stage_tiled.cu``), E
  (``csrc/slab_tiled.cu``), G (``csrc/mass_tiled.cu``), H and I
  (``csrc/lf_tiled.cu``) and J's step boundary (``csrc/rk42_tiled.cu``),
  whose plane windows arrive by TMA into a ring of RING planes (fewer for
  J's boundary and A's stages of two and three fields): TZ a multiple of
  one 16-byte unit, so every box's z start is 16-byte aligned, and the box
  within BOX_MAX along each axis; one more layer of blocks (more for A)
  writes the outputs' padding.

Each result is computed once per set of arguments (every launch asks for
it). The constants are the kernels' own; ``tests/test_torch_tiling.py``
reads them back from the sources.
"""

from __future__ import annotations

import functools
from typing import TYPE_CHECKING

import torch

if TYPE_CHECKING:
    from .wave import PaddedLayout

__all__ = [
    "TILE_THREADS", "TILE_Z", "PIPE", "H100_SMS", "RING", "BOX_MAX", "CHUNK_X_TMA",
    "PADDING_LAYERS", "tma_blocks_per_sm", "grid_rows", "grid_pitch", "window_pitch",
    "grid_geometry", "tma_window", "tma_smem_bytes",
    "tma_geometry", "tma_padding_first", "check_tma_launch", "SMEM_LIMIT", "sm_count",
]

#: the tiling limits: threads of a tile block at most (stencil_tiled.cuh
#: kTileThreads), tile width along z (the fast lanes) at most
TILE_THREADS = 256
TILE_Z = 32
#: x planes in kernel F's cp.async ring (stencil_tiled.cuh kPipe)
PIPE = 4
#: the SMs of an H100 SXM
H100_SMS = 132
#: plane windows in the TMA ring (stencil_tiled.cuh kRing), a TMA box's
#: extent along any axis at most (kBoxMax), and the least and the most
#: x-chunk rows of the TMA kernels and kernel F (at p = 8-10 each chunk
#: streams 2p warm-up planes)
RING = 6
BOX_MAX = 256
CHUNK_X_TMA = (16, 128)
#: layers of padding blocks at the end of a TMA kernel's grid
#: (stencil_tiled.cuh::tma_tiling_fits)
PADDING_LAYERS = 1
#: bytes of shared memory a block may use on an H100 (227 KB)
SMEM_LIMIT = 232_448


def tma_blocks_per_sm(itemsize: int) -> int:
    """Tile blocks an SM holds at once for the TMA kernels and kernel F: the
    launch bounds of ``csrc/stencil_tiled.cuh::tma_min_blocks<T>``."""
    return 2 if itemsize <= 4 else 1


def grid_rows(itemsize: int, p: int) -> int:
    """Rows of its tile column a thread of kernel F owns
    (``csrc/stiffness_tiled.cu::grid_rows<T, P>``)."""
    return 2 if itemsize <= 4 and p <= 4 else 1


def _cdiv(n: int, d: int) -> int:
    return -(-n // d)


def _tiles(Ny, Nz, tz_max, tile_threads, tz_unit=1, ty_max=None, rows=1):
    """(z tiles, TZ, y tiles, TY): tiles as even as the interior allows, TZ
    a multiple of ``tz_unit``, at most ``tile_threads`` threads a tile,
    each owning ``rows`` rows of a column (TY a multiple of ``rows``)."""
    nz_tiles = _cdiv(Nz, tz_max)
    tz = _cdiv(_cdiv(Nz, nz_tiles), tz_unit) * tz_unit
    nz_tiles = _cdiv(Nz, tz)
    ty_cap = tile_threads // tz * rows
    if ty_max is not None:
        ty_cap = min(ty_cap, ty_max)
    ny_tiles = _cdiv(Ny, ty_cap)
    ty = _cdiv(_cdiv(Ny, ny_tiles), rows) * rows
    return nz_tiles, tz, _cdiv(Ny, ty), ty


def _chunks(Nx, p, tiles, slots, chunk_x):
    """The x-chunk count that fills the ``slots`` block slots of the card in
    as few waves as it can, weighed against the 2p warm-up planes each
    chunk reads: a block streams its chunk from start to end, so a last
    wave that is a fraction full costs as much as a full one."""

    def score(n):
        cx = _cdiv(Nx, n)
        blocks = tiles * n
        return blocks / (_cdiv(blocks, slots) * slots) * cx / (cx + 2 * p)

    return max(range(_cdiv(Nx, chunk_x[1]), _cdiv(Nx, chunk_x[0]) + 1), key=score)


def grid_pitch(tz: int, p: int, rows: int) -> int:
    """The pitch of kernel F's plane window in shared memory
    (``csrc/stiffness_tiled.cu::grid_pitch``): at least TZ + 2p, with
    ``rows`` x pitch = TZ (mod 32), so that a warp's tap loads fall in 32
    distinct banks."""
    base = tz // rows
    return base + _cdiv(tz + 2 * p - base, 32 // rows) * (32 // rows)


def window_pitch(tz: int, p: int, rows: int, Nz: int, itemsize: int) -> int:
    """Kernel F's window pitch (``csrc/stiffness_tiled.cu::window_pitch``):
    :func:`grid_pitch`, and in bf16 one more where its parity is not
    ``Nz``'s, so that a window point has its global index's parity and the
    pairs are copied 4 bytes at a time."""
    W = grid_pitch(tz, p, rows)
    return W + ((W - Nz) & 1) if itemsize == 2 else W


def grid_geometry(shape, p: int, itemsize: int = 4, sms: int = H100_SMS):
    """(grid, TY, TZ, CX, smem_bytes) of kernel F on the unpadded dof grid
    ``shape`` [Nx, Ny, Nz]: :func:`tma_geometry`'s tiles and chunks on the
    grid itself (no padding: the tiles start at 0), a thread owning grid_rows
    rows of its column (TY and TZ multiples of it, TY / grid_rows x TZ
    threads), the chunks filling tma_blocks_per_sm blocks an SM, CX within
    CHUNK_X_TMA (2p warm-up planes a chunk up to p = 10); ``smem_bytes``
    holds a ring of PIPE planes of TY + 2p rows at the pitch of
    :func:`grid_pitch` and the window's copy table (two int32 a point); in
    bf16 a ring of slots of the rows at :func:`window_pitch` plus room for
    the window's shift (even), and one int32 of the table a pitch point."""
    return _grid_geometry(tuple(shape), p, itemsize, sms)


@functools.cache
def _grid_geometry(shape, p, itemsize, sms):
    Nx, Ny, Nz = shape
    rows = grid_rows(itemsize, p)
    nz_tiles, tz, ny_tiles, ty = _tiles(Ny, Nz, TILE_Z, TILE_THREADS, tz_unit=rows,
                                        rows=rows)
    chunks = _chunks(Nx, p, nz_tiles * ny_tiles, sms * tma_blocks_per_sm(itemsize),
                     CHUNK_X_TMA)
    cx = _cdiv(Nx, chunks)
    if itemsize == 2:
        n = (ty + 2 * p) * window_pitch(tz, p, rows, Nz, itemsize)
        smem = PIPE * ((n + 2) & ~1) * itemsize + 4 * n
    else:
        smem = (PIPE * (ty + 2 * p) * grid_pitch(tz, p, rows) * itemsize
                + 8 * (ty + 2 * p) * (tz + 2 * p))
    return (nz_tiles, ny_tiles, _cdiv(Nx, cx)), ty, tz, cx, smem


def tma_window(h: int, p: int, ty: int, tz: int, itemsize: int):
    """(W, BY, oz, box) of ``csrc/stencil_tiled.cuh::tma_window``: the box's
    z extent W (TZ plus a multiple of 32, so that a warp's tap loads from
    the window fall in 32 distinct banks), its y extent BY = TY + 2p, the
    halo's offset oz = (h - p) mod A in the box (A = 16 / itemsize, the
    points of a 16-byte unit), and the elements a box takes in shared
    memory (bytes rounded up to 128)."""
    oz = (h - p) % (16 // itemsize)
    W = tz + _cdiv(oz + 2 * p, 32) * 32
    BY = ty + 2 * p
    return W, BY, oz, _cdiv(W * BY * itemsize, 128) * 128 // itemsize


def tma_smem_bytes(window, itemsize: int, fields: int, extra: int,
                   ring: int = RING) -> int:
    """Dynamic shared memory of a TMA tile block
    (``stencil_tiled.cuh::tma_smem_bytes``): 128 bytes to align the base,
    ``ring`` slots of ``fields`` boxes and ``extra`` boxes, ``ring``
    mbarriers."""
    box = window[3]
    return 128 + (ring * fields + extra) * box * itemsize + ring * 8


def tma_geometry(layout: PaddedLayout, itemsize: int = 4, sms: int = H100_SMS,
                 fields: int = 1, extra: int = 0, ring: int = RING,
                 box_ring: int = 0):
    """(grid, TY, TZ, CX, smem_bytes) of a TMA tile kernel on ``layout``'s
    box grown by ``box_ring`` (``PaddedLayout.box``; the interior for 0):
    kernels B, E, H and I take one field a plane (``fields=1, extra=0``),
    kernel G one and two z-contracted planes (``fields=1, extra=2``; its
    launch adds cvx of a chunk's rows, ``ops/mass.py``), kernel D two
    (u0, ku) and two stage-input planes (``fields=2, extra=2``), J's step
    boundary five (u0, v0, kv0, kv1, kv2) and two pairs of formed planes
    in a ring of ``ring`` planes (``fields=5, extra=4``). As
    :func:`tiled_geometry`, with TZ a multiple of the 16-byte unit and the
    box within BOX_MAX; the chunks fill tma_blocks_per_sm blocks an SM. The
    grid has PADDING_LAYERS more layers of x-chunks than the tiling needs:
    their blocks write the outputs' padding while the tile blocks stream
    (``stencil_tiled.cuh::padding_block``)."""
    _, nx, h, ny, nz = layout.box(box_ring)
    return _tma_geometry((nx, ny, nz), layout.p, h, itemsize, sms, fields, extra,
                         ring)


@functools.cache
def _tma_geometry(shape, p, h, itemsize, sms, fields, extra, ring):
    Nx, Ny, Nz = shape
    nz_tiles, tz, ny_tiles, ty = _tiles(Ny, Nz, TILE_Z, TILE_THREADS,
                                        tz_unit=16 // itemsize,
                                        ty_max=BOX_MAX - 2 * p)
    chunks = _chunks(Nx, p, nz_tiles * ny_tiles, sms * tma_blocks_per_sm(itemsize),
                     CHUNK_X_TMA)
    cx = _cdiv(Nx, chunks)
    smem = tma_smem_bytes(tma_window(h, p, ty, tz, itemsize), itemsize, fields, extra,
                          ring)
    return (nz_tiles, ny_tiles, _cdiv(Nx, cx) + PADDING_LAYERS), ty, tz, cx, smem


def tma_padding_first(grid, itemsize: int = 4, sms: int = H100_SMS) -> bool:
    """Whether a TMA kernel's padding layer should be the grid's first
    (kernels H and I, ``csrc/lf_tiled.cu``): where the tile blocks take more
    than one wave of the card's block slots. Last, the padding blocks would
    wait for the tile blocks' last wave and end after it; first, they share
    the first wave and delay some tile blocks by their own short time.
    Where the tile blocks fit one wave, the padding layer goes last: its
    blocks take the slots the tiles leave and delay none of them (on the
    H100, f32: P2 at p = 4, 525 tile blocks in 264 slots, first, 14 %
    faster than last; P3 at p = 8, 225 tile blocks, last, 18 % faster than
    first). The rule is H's and I's only: kernel G and J's step boundary
    measured 3-5 % faster with their padding layer last, J's boundary on
    I's own grid of 525 tile blocks, so the wave count does not decide for
    every kernel, and those two always put it last."""
    gx, gy, gz = grid
    tiles = gx * gy * (gz - PADDING_LAYERS)
    return tiles > sms * tma_blocks_per_sm(itemsize)


def check_tma_launch(layout: PaddedLayout, itemsize: int, ty: int, tz: int,
                     smem: int, box_ring: int = 0) -> None:
    """Raise a ValueError naming the condition a TMA tile kernel's launch on
    ``layout``'s box grown by ``box_ring`` breaks (``stencil_tiled.cuh::
    tma_fits``, the launchers' rules): every tap of a point of the box
    inside the state, the rows of the state a multiple of 16 bytes (the
    tensor map's pitch), the box within BOX_MAX, the shared memory within
    SMEM_LIMIT."""
    p, Lz = layout.p, layout.padded_shape[2]
    if layout.x0 < p or layout.h < p:
        raise ValueError(f"tile_x = {layout.tile_x} and the y/z padding {layout.h} "
                         f"must be >= p = {p}")
    x0, _, h, _, _ = layout.box(box_ring)
    if (Lz * itemsize) % 16:
        raise ValueError(f"a padded z row of {Lz} x {itemsize} bytes is no multiple "
                         "of 16 bytes (the TMA tensor map's row pitch)")
    W, BY, _, _ = tma_window(h, p, ty, tz, itemsize)
    if W > BOX_MAX or BY > BOX_MAX:
        raise ValueError(f"the plane window {W} x {BY} exceeds the TMA box's "
                         f"{BOX_MAX} points along an axis")
    if smem > SMEM_LIMIT:
        raise ValueError(f"the launch needs {smem} bytes of shared memory a block, "
                         f"more than the {SMEM_LIMIT} an H100 block may use")


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA card ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count
