"""The tiling of the RK4 stage kernel (kernels A and C, and kernel J's
stages; csrc/rk4_tiled.cu) on the layouts the app and chip_smoke.py build
for the step path, and the C launcher's argument list. CPU only: the
geometry is plain Python, so it is checked here for every p the kernel
takes (1..8)."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from wave_fenics_tpu_torch.ops import _cuda, rk4step
from wave_fenics_tpu_torch.ops.rk4step import _off0, stage_launch_args, tiled_geometry
from wave_fenics_tpu_torch.ops.wave import PaddedLayout

SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on an H100
MIN_BLOCKS_P1 = 2 * 132  # two tile blocks per SM at the headline size

# (cells, tile_x or None for the step path's smallest tile): the headline
# P1 (64x32x32, tile 48), p=8 at 32x16x16 cells (tile 24), the f64 checks'
# (4,2,2) and ragged (5,3,3) and (9,4,8) cells
CASES = [((64, 32, 32), 48), ((32, 16, 16), 24), ((4, 2, 2), None),
         ((5, 3, 3), None), ((9, 4, 8), None)]


def _layout(cells, p, tile_x):
    shape = tuple(c * p + 1 for c in cells)
    tx = max(16, _off0(p)) if tile_x is None else max(tile_x, _off0(p))
    return PaddedLayout(shape, p, tile_x=tx, z_align=16)


def _axis_ranges(start, n, tile, count):
    """The interior ranges the kernel's blocks take along one axis
    (TileCoords in csrc/stencil_tiled.cuh)."""
    return [(start + i * tile, min(start + (i + 1) * tile, start + n))
            for i in range(count)]


@pytest.mark.parametrize("cells,tile_x", CASES)
@pytest.mark.parametrize("p", range(1, 9))
def test_tiles_cover_the_interior_once(p, cells, tile_x):
    lay = _layout(cells, p, tile_x)
    Nx, Ny, Nz = lay.shape
    Lx, Ly, Lz = lay.padded_shape
    for itemsize in (4, 8):
        grid, ty, tz, cx, smem = tiled_geometry(lay, itemsize)
        assert ty * tz <= rk4step.TILE_THREADS and tz <= rk4step.TILE_Z
        assert cx <= rk4step.CHUNK_X[1] and smem <= SMEM_LIMIT
        window = (ty + 2 * p) * (tz + 2 * p)
        assert smem == rk4step.PIPE * 3 * window * itemsize + 4 * window
    ranges = [
        _axis_ranges(lay.x0, Nx, cx, grid[2]),
        _axis_ranges(lay.h, Ny, ty, grid[1]),
        _axis_ranges(lay.h, Nz, tz, grid[0]),
    ]
    for (start, n, L), rs in zip(((lay.x0, Nx, Lx), (lay.h, Ny, Ly), (lay.h, Nz, Lz)),
                                 ranges):
        hits = np.zeros(L, dtype=int)
        for lo, hi in rs:
            assert lo < hi  # no empty tile
            hits[lo:hi] += 1
        assert (hits[start:start + n] == 1).all() and hits.sum() == n
        # the x taps and the y/z halo of every tile stay inside the state
        assert rs[0][0] - p >= 0 and rs[-1][1] + p <= L
    if np.prod(lay.padded_shape) <= 2_000_000:  # the whole box, point by point
        count = np.zeros(lay.padded_shape, dtype=int)
        for x in ranges[0]:
            for y in ranges[1]:
                for z in ranges[2]:
                    count[x[0]:x[1], y[0]:y[1], z[0]:z[1]] += 1
        inside = np.zeros_like(count)
        inside[lay.interior] = 1
        np.testing.assert_array_equal(count, inside)


def test_headline_grid_fills_the_card():
    lay = _layout((64, 32, 32), 4, 48)
    assert lay.padded_shape == (384, 144, 144)
    grid, ty, tz, cx, _ = tiled_geometry(lay)
    blocks = grid[0] * grid[1] * grid[2]
    assert blocks >= MIN_BLOCKS_P1
    # one wave of the 4 x 132 block slots, nearly full: 75 tiles x 7 chunks
    assert 0.95 * rk4step.BLOCKS_PER_SM * 132 <= blocks <= rk4step.BLOCKS_PER_SM * 132
    # a ragged last tile wastes under a tenth of the threads along y and z
    assert ty * grid[1] <= 1.1 * 129 and tz * grid[0] <= 1.1 * 129
    # a card with fewer SMs gets fewer blocks per wave, not a ragged wave
    grid, *_ = tiled_geometry(lay, sms=114)
    assert grid[0] * grid[1] * grid[2] <= rk4step.BLOCKS_PER_SM * 114


def test_ragged_card_test_grid_is_ragged():
    """The card tests' ragged grid ((9,4,8) cells at p=4) is no multiple of
    the tiling's CX, TY or TZ, so the last chunk and tiles are partial."""
    lay = _layout((9, 4, 8), 4, None)
    _, ty, tz, cx, _ = tiled_geometry(lay, 8)
    Nx, Ny, Nz = lay.shape
    assert Nx % cx and Ny % ty and Nz % tz


def test_geometry_limits_are_arguments_and_results_are_cached():
    """Other limits give another tiling without touching the default one,
    and a repeated call returns the cached result (every stage launch asks
    for it)."""
    lay = _layout((64, 32, 32), 4, 48)
    default = tiled_geometry(lay)
    assert tiled_geometry(PaddedLayout(lay.shape, 4, tile_x=48, z_align=16)) is default
    other = tiled_geometry(lay, tile_z=16, tile_threads=128, chunk_x=(16, 16))
    _, ty, tz, cx, _ = other
    assert other != default and tz <= 16 and ty * tz <= 128 and cx == 16
    assert tiled_geometry(lay) is default


def _c_source(name):
    return (Path(_cuda.CSRC) / name).read_text()


def test_python_tiling_policy_matches_the_c_kernel():
    """The constants tiled_geometry sizes the launch with are the kernel's
    own: the block's thread limit, the cp.async ring, the fields a plane
    holds at most, and the blocks an SM must hold (the launch bounds)."""
    hdr = _c_source("stencil_tiled.cuh")
    src = _c_source("rk4_tiled.cu")
    c_int = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", hdr).group(1))  # noqa: E731
    assert c_int("kTileThreads") == rk4step.TILE_THREADS
    assert c_int("kPipe") == rk4step.PIPE
    fields = re.search(r"return J == 0 \? (\d+) : J == 1 \? (\d+) : (\d+);", src)
    assert max(int(n) for n in fields.groups()) == rk4step.PLANE_FIELDS
    rule = re.search(r"min_blocks\(\) \{\s*return sizeof\(T\) == (\d+) && P <= (\d+) "
                     r"\? (\d+) : (\d+);", src)
    size, pmax, many, one = (int(n) for n in rule.groups())
    for itemsize in (4, 8):
        for p in range(1, 9):
            want = many if itemsize == size and p <= pmax else one
            assert rk4step.blocks_per_sm(itemsize, p) == want


def test_point_only_ablation_patches_one_line():
    """profile_step --ablate replaces the stencil line of kernels A and C by
    the point value in a copy of the sources; the line is there once."""
    from wave_fenics_tpu_torch.apps.profile_step import POINT_ONLY

    assert _c_source("rk4_tiled.cu").count(POINT_ONLY[0]) == 1


def _tensor(n=1):
    return torch.zeros(n, dtype=torch.float32)


@pytest.mark.parametrize("name", ["wave_rk4_stage", "wave_rk4_full_stage"])
def test_launch_args_match_the_c_signature(name):
    """The wrapper's arguments have the types ctypes declares for the
    launcher, and the launcher's C prototype has as many parameters."""
    lay = _layout((4, 2, 2), 4, None)
    st = tuple(_tensor() for _ in range(5))
    args = stage_launch_args(3, *(_tensor() for _ in range(10)), 5, -1, 1e-9, 0.5,
                             1500.0, lay, st)
    sig = _cuda._SIGNATURES[name]
    kinds = {ctypes.c_void_p: torch.Tensor, ctypes.c_int: int, ctypes.c_double: float}
    assert len(args) + 1 == len(sig) and sig[-1] is ctypes.c_void_p  # + stream
    for a, t in zip(args, sig):
        assert type(a) is kinds[t] or isinstance(a, kinds[t])
    grid, ty, tz, cx, smem = tiled_geometry(lay)
    assert args[-7:] == (ty, tz, cx, *grid, smem)
    src = (Path(_cuda.CSRC) / "rk4_tiled.cu").read_text()
    proto = re.search(r'extern "C" int NAME##_##SUFFIX\((.*?)\)\s*\{', src, re.S)
    params = [q for q in proto.group(1).replace("\\", " ").split(",") if q.strip()]
    assert len(params) == len(sig)
