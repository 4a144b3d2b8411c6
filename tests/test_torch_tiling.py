"""The tilings of the tiled stencil kernels on the layouts the app and
chip_smoke.py build, and the C launchers' argument lists: the RK4 stage
kernel (kernels A and C, and kernel J's stages; csrc/rk4_tiled.cu, TMA
plane loads) at every p it takes (1..8), kernel F on the unpadded dof grid (csrc/stiffness_tiled.cu,
p = 1..10), and the TMA kernels B (csrc/flat_tiled.cu, p = 1..8), D
(csrc/rk_stage_tiled.cu, p = 1..8), E (csrc/slab_tiled.cu, p = 1..10), G
(the BP1 mass, csrc/mass_tiled.cu, p = 1..8) and J's step boundary
(csrc/rk42_tiled.cu, p = 1..8). CPU only: the geometry is plain Python, so
it is checked here."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from wave_fenics_tpu_torch.models.linear_wave_padded import _flat_tile_x
from wave_fenics_tpu_torch.core.mesh import box_mesh
from wave_fenics_tpu_torch.ops import (
    _cuda,
    lf2step,
    lfstep,
    mass,
    rk42step,
    stiffness,
    tiling,
    wave,
)
from wave_fenics_tpu_torch.ops.rk4step import (
    STAGE_EXTRA,
    STAGE_FIELDS,
    _off0,
    stage_blocks_per_sm,
    stage_launch_args,
    stage_ring,
)
from wave_fenics_tpu_torch.ops import rk4step as rk4step_mod
from wave_fenics_tpu_torch.ops.rk4step import stage_geometry
from wave_fenics_tpu_torch.ops.wave import PaddedLayout

SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on an H100
SM_SMEM = 233_472  # bytes of shared memory an H100 SM holds (228 KB)
SM_RESERVED = 1_024  # bytes the runtime reserves per resident block
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


def _stage_geometry(lay, stage, itemsize=4, sms=tiling.H100_SMS, box_ring=0):
    """Kernel A's (C's) tiling of stage ``stage`` (ops/rk4step.py::
    stage_geometry) on a card of ``sms`` SMs."""
    return rk4step_mod._stage_geometry(lay, stage, itemsize, sms, box_ring)[:5]


def _stage_layers(grid, Nx, cx):
    """Layers of padding blocks beyond the x-chunks of a stage's grid."""
    return grid[2] - -(-Nx // cx)


@pytest.mark.parametrize("cells,tile_x", CASES)
@pytest.mark.parametrize("p", range(1, 9))
def test_tiles_cover_the_interior_once(p, cells, tile_x):
    """Kernel A's (C's) TMA tiling, every stage, in bf16, f32 and f64: the
    four stages share the tiles, chunks and grid (layers of padding blocks
    beyond the x-chunks, two padding blocks an SM at least) and differ in
    their shared memory only; the tiles cover the interior exactly once and
    the padding pass the rest; every tile's box starts 16-byte aligned
    along z and holds its p-deep halo within the TMA's 256-point
    extents."""
    lay = _layout(cells, p, tile_x)
    Nx, Ny, Nz = lay.shape
    for itemsize in (2, 4, 8):
        geos = [_stage_geometry(lay, j, itemsize) for j in range(4)]
        grid, ty, tz, cx, _ = geos[0]
        assert all(g[:4] == (grid, ty, tz, cx) for g in geos)
        W, BY, oz, box = window = tiling.tma_window(lay.h, p, ty, tz, itemsize)
        assert ty * tz <= tiling.TILE_THREADS and tz <= tiling.TILE_Z
        assert tz % (16 // itemsize) == 0 and cx <= tiling.CHUNK_X_TMA[1]
        assert W <= tiling.BOX_MAX and BY == ty + 2 * p <= tiling.BOX_MAX
        assert oz + tz + 2 * p <= W
        for bz in range(grid[0]):
            assert ((lay.h + bz * tz - p - oz) * itemsize) % 16 == 0
        for j, (*_, smem) in enumerate(geos):
            nf = STAGE_FIELDS[j]
            assert smem == tiling.tma_smem_bytes(window, itemsize, nf, STAGE_EXTRA[j],
                                                 stage_ring(nf)) <= SMEM_LIMIT
        layers = _stage_layers(grid, Nx, cx)
        assert grid[:2] == (-(-Nz // tz), -(-Ny // ty))
        assert layers == -(-2 * tiling.H100_SMS // (grid[0] * grid[1])) >= 1
        assert layers * grid[0] * grid[1] >= 2 * tiling.H100_SMS
    _covers_once(lay, (grid[0], grid[1], grid[2] - layers + tiling.PADDING_LAYERS), ty, tz,
                 cx, p)


def test_headline_grid_fills_the_card():
    """At P1 kernel A's 75 tiles of 9 x 28 take 7 x-chunks of 37 rows: 525
    tile blocks, one wave of the H100's 4 x 132 block slots, nearly full,
    so the padding blocks go last, four layers of them (two an SM); in bf16
    (tiles of 8 x 32, 85 a layer) 7 chunks and four layers too."""
    lay = _layout((64, 32, 32), 4, 48)
    assert lay.padded_shape == (384, 144, 144)
    x = torch.zeros(1)
    grid, ty, tz, cx, _ = _stage_geometry(lay, 3)
    slots = stage_blocks_per_sm(4, 4) * 132
    layers = _stage_layers(grid, 257, cx)
    tiles = grid[0] * grid[1] * (grid[2] - layers)
    assert (ty, tz, cx, layers) == (9, 28, 37, 4) and tiles == 525 >= MIN_BLOCKS_P1
    assert 0.95 * slots <= tiles <= slots
    assert not any(stage_geometry(x, lay, j)[5] for j in range(4))
    # a ragged last tile wastes under a tenth of the threads along y and z
    assert ty * grid[1] <= 1.1 * 129 and tz * grid[0] <= 1.1 * 129
    grid, ty, tz, cx, _ = _stage_geometry(lay, 3, 2)
    assert (ty, tz, grid[2] - -(-257 // cx)) == (8, 32, 4)
    # a card with fewer SMs gets fewer blocks per wave, not a ragged wave
    grid, _, _, cx, _ = _stage_geometry(lay, 3, sms=114)
    tiles = grid[0] * grid[1] * (grid[2] - _stage_layers(grid, 257, cx))
    assert tiles <= stage_blocks_per_sm(4, 4) * 114


def test_ragged_card_test_grid_is_ragged():
    """The card tests' ragged grid ((9,4,8) cells at p=4) is no multiple of
    kernel A's CX, TY or TZ in f64, so the last chunk and tiles are
    partial."""
    lay = _layout((9, 4, 8), 4, None)
    _, ty, tz, cx, _ = _stage_geometry(lay, 3, 8)
    Nx, Ny, Nz = lay.shape
    assert Nx % cx and Ny % ty and Nz % tz


def test_geometry_limits_are_arguments_and_results_are_cached():
    """A stage's fields, stage-input planes and ring depth, the card's SMs
    and the box's ring are arguments: another stage, card or box gives
    another geometry without touching the first, and a repeated call
    returns the cached result (every stage launch asks for it)."""
    geo = rk4step_mod._stage_geometry
    lay = _layout((64, 32, 32), 4, 48)
    default = geo(lay, 3, 4, 132, 0)
    same = PaddedLayout(lay.shape, 4, tile_x=48, z_align=16)
    assert geo(same, 3, 4, 132, 0) is default
    assert geo(lay, 2, 4, 132, 0) == default  # stages 2 and 3: three fields
    first, one = geo(lay, 0, 4, 132, 0), geo(lay, 1, 4, 132, 0)
    assert first[:4] == one[:4] == default[:4]
    assert first[4] < one[4] < default[4]
    assert geo(lay, 3, 4, 114, 0) != default
    halo = PaddedLayout(lay.shape, 4, tile_x=48, z_align=16, halo=12)
    assert geo(halo, 0, 4, 132, 4) != geo(halo, 0, 4, 132, 0)
    assert geo(lay, 3, 4, 132, 0) is default
    assert stage_geometry(torch.zeros(1), lay, 3) is default


@pytest.mark.parametrize("p", range(1, 9))
def test_stage_shared_memory_within_the_sm(p):
    """Kernel A's (C's) shared memory at every p, on the headline layout
    and the card tests' small ones: 1, 2 and 3 TMA fields a plane (stages
    0, 1 and 2-3) in their rings and the two stage-input planes, in bf16,
    f32 and f64, within a block's 227 KB, and the blocks an SM the launch
    bounds ask for (four at p <= 4 in f32 and bf16) within the SM's 228
    KB."""
    for cells, tile_x in CASES:
        lay = _layout(cells, p, tile_x)
        for itemsize in (2, 4, 8):
            for j in range(4):
                *_, smem = _stage_geometry(lay, j, itemsize)
                assert smem <= SMEM_LIMIT
                blocks = stage_blocks_per_sm(itemsize, p)
                assert blocks * (smem + SM_RESERVED) <= SM_SMEM


def _c_source(name):
    return (Path(_cuda.CSRC) / name).read_text()


def _py_source(name):
    return (Path(_cuda.CSRC).parent / name).read_text()


def _zero_padding_count(lay, blocks, nt, itemsize):
    """How often csrc/rk4_tiled.cu::zero_padding writes each point of the
    padded state when ``blocks`` blocks of ``nt`` threads run it: the
    16-byte units of the x planes outside the box, grid-stride over every
    thread; the box's planes' (x, y) rows, a contiguous run to each group
    of min(32, nt) threads, a row outside the box's rows whole, the
    others' z points outside the box."""
    V = 16 // itemsize
    Lx, Ly, Lz = lay.padded_shape
    x0, nx, h, ny, nz = lay.box(0)
    count = np.zeros(Lx * Ly * Lz, dtype=int)
    lo, hi, end = x0 * Ly * Lz // V, (x0 + nx) * Ly * Lz // V, Lx * Ly * Lz // V
    n = lo + (end - hi)
    for t in range(blocks * nt):
        for i in range(t, n, blocks * nt):
            k = i if i < lo else i - lo + hi
            count[k * V:(k + 1) * V] += 1
    gs = min(32, nt)
    groups = nt // gs
    rows, ng = nx * Ly, blocks * groups
    for k in range(ng):
        r, r1 = rows * k // ng, rows * (k + 1) // ng
        g, y = x0 + r // Ly, r % Ly
        for _ in range(r, r1):
            base = (g * Ly + y) * Lz
            if y < h or y >= h + ny:
                count[base:base + Lz] += 1
            else:
                count[base:base + h] += 1
                count[base + h + nz:base + Lz] += 1
            y += 1
            if y == Ly:
                y, g = 0, g + 1
    return count.reshape(lay.padded_shape)


@pytest.mark.parametrize("cells", [(4, 2, 2), (5, 3, 3)])
@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_stage_padding_pass_writes_the_padding_once(p, cells):
    """Kernel A's (C's) padding blocks, as many as its grid's padding layers
    hold, write every point outside the interior exactly once and no point
    inside it, in bf16, f32 and f64."""
    lay = _layout(cells, p, None)
    outside = np.ones(lay.padded_shape, dtype=int)
    outside[lay.interior] = 0
    for itemsize in (2, 4, 8):
        grid, ty, tz, cx, _ = _stage_geometry(lay, 3, itemsize)
        blocks = grid[0] * grid[1] * _stage_layers(grid, lay.shape[0], cx)
        np.testing.assert_array_equal(_zero_padding_count(lay, blocks, ty * tz, itemsize),
                                      outside)


def test_python_tiling_policy_matches_the_c_kernel():
    """The constants grid_geometry and tma_geometry size the launches with
    are the kernels' own: the block's thread limit, kernel F's cp.async
    ring, the TMA ring and box limit, kernel A's (C's) fields, stage-input
    planes and ring depth a stage, and the blocks an SM must hold (the
    launch bounds of kernels A/C, D, E and the other TMA kernels)."""
    hdr = _c_source("stencil_tiled.cuh")
    src = _c_source("rk4_tiled.cu")
    c_int = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", hdr).group(1))  # noqa: E731
    assert c_int("kTileThreads") == tiling.TILE_THREADS
    assert c_int("kPipe") == tiling.PIPE
    assert c_int("kRing") == tiling.RING
    assert c_int("kBoxMax") == tiling.BOX_MAX
    layers = re.search(r"return grid.z >= (\d+) && tiling_fits\(t, dim3\(grid.x, grid.y, "
                       r"grid.z - (\d+)\)", hdr)
    assert int(layers.group(1)) - 1 == int(layers.group(2)) == tiling.PADDING_LAYERS
    # kernels A and C: a stage's TMA fields, stage-input planes and ring
    fields = re.search(r"return J == 0 \? (\d+) : J == 1 \? (\d+) : (\d+);", src)
    f0, f1, f2 = (int(n) for n in fields.groups())
    assert STAGE_FIELDS == (f0, f1, f2, f2)
    extra = re.search(r"stage_extra\(\) \{\s*return J == 0 \? (\d+) : (\d+);", src)
    e0, e1 = (int(n) for n in extra.groups())
    assert STAGE_EXTRA == (e0, e1, e1, e1)
    ring = re.search(r"stage_ring\(\) \{\s*return NF == 1 \? kRing : NF == 2 \? (\d+) : (\d+);",
                     src)
    assert (stage_ring(1), stage_ring(2), stage_ring(3)) == (
        tiling.RING, *(int(n) for n in ring.groups()))
    rule = re.search(r"stage_min_blocks\(\) \{\s*return sizeof\(T\) <= (\d+) && P <= (\d+) "
                     r"\? (\d+) : tma_min_blocks<T>\(\);", src)
    size, pmax, many = (int(n) for n in rule.groups())
    for itemsize in (2, 4, 8):
        for p in range(1, 9):
            want = many if itemsize <= size and p <= pmax else tiling.tma_blocks_per_sm(itemsize)
            assert stage_blocks_per_sm(itemsize, p) == want
    assert "__launch_bounds__(kTileThreads, (stage_min_blocks<T, P>()))" in src
    assert "PlaneRing<T, R> ring(smem_raw, w, NF, stage_extra<J>())" in src
    assert "tma_smem_bytes<T>(w, NF, stage_extra<J>(), stage_ring<NF>())" in src
    # the other TMA kernels: launch bounds of tma_min_blocks<T>
    rule = re.search(r"tma_min_blocks\(\) \{\s*return sizeof\(T\) <= (\d+) \? (\d+) : (\d+);",
                     hdr)
    size, many, one = (int(n) for n in rule.groups())
    for itemsize in (2, 4, 8):
        assert tiling.tma_blocks_per_sm(itemsize) == (many if itemsize <= size else one)
    for name in ("slab_tiled.cu", "rk_stage_tiled.cu", "lf_tiled.cu", "mass_tiled.cu",
                 "rk42_tiled.cu", "flat_tiled.cu"):
        assert "__launch_bounds__(kTileThreads, (tma_min_blocks<T>()))" in _c_source(name)
    # kernel F: the TMA kernels' launch bounds, grid_rows<T, P>, one field a
    # plane of the cp.async ring
    src = _c_source("stiffness_tiled.cu")
    rule = re.search(r"grid_rows\(\) \{\s*return sizeof\(T\) <= (\d+) && P <= (\d+) "
                     r"\? (\d+) : (\d+);", src)
    size, pmax, two, one = (int(n) for n in rule.groups())
    for itemsize in (2, 4, 8):
        for p in range(1, 11):
            want = two if itemsize <= size and p <= pmax else one
            assert tiling.grid_rows(itemsize, p) == want
    assert "__launch_bounds__(kTileThreads, (tma_min_blocks<T>()))" in src
    assert "smem < grid_smem_bytes<T, P>(t, R, s.nz)" in src
    assert "return kPipe * window_slot<T>(rows, W) * (int)sizeof(T) +" in src
    assert "rows * (t.tz + 2 * P) * (int)sizeof(int2));" in src
    # bf16: pairs of the window's pitch, one int32 of the table a point
    assert "(copy_width<T>() == 2 ? rows * W * (int)sizeof(int)" in src
    assert "return copy_width<T>() == 2 ? (rows * W + 2) & ~1 : rows * W;" in src
    assert "return copy_width<T>() == 2 ? W + ((W - Nz) & 1) : W;" in src
    assert "case %d: return launch_grid<T, %d>" % ((stiffness.MAX_DEGREE,) * 2) in src
    # kernel B: one TMA field a plane, no extra planes
    src = _c_source("flat_tiled.cu")
    assert "PlaneRing<T> ring(smem_raw, w, 1, 0)" in src
    assert "smem < tma_smem_bytes<T>(w, 1, 0)" in src
    # kernel J's step boundary: its ring depth and its planes
    rule = re.search(r"boundary_ring\(\) \{\s*return sizeof\(T\) == (\d+) \? (\d+) : (\d+);",
                     _c_source("rk42_tiled.cu"))
    size, many, one = (int(n) for n in rule.groups())
    for itemsize in (4, 8):
        assert rk42step.boundary_ring(itemsize) == (many if itemsize == size else one)
    assert ("PlaneRing<T, R> ring(smem_raw, w, %d, %d)"
            % (rk42step.BOUNDARY_FIELDS, rk42step.BOUNDARY_EXTRA)) in _c_source("rk42_tiled.cu")
    assert ("tma_smem_bytes<T>(w, %d, %d, boundary_ring<T>())"
            % (rk42step.BOUNDARY_FIELDS, rk42step.BOUNDARY_EXTRA)) in _c_source("rk42_tiled.cu")
    # kernel G: one field, two z-contracted planes of Acc<T> (two boxes of T
    # each in bf16, as mass_launch_args asks for), then cvx of a chunk's rows
    src = _c_source("mass_tiled.cu")
    assert "PlaneRing<T> ring(smem_raw, w, 1, 2 * ZB)" in src
    assert ("return tma_smem_bytes<T>(w, 1, 2 * z_boxes<T>()) + (2 * P + 1) * t.cx * "
            "(int)sizeof(T);") in src
    assert "return (int)(sizeof(Acc<T>) / sizeof(T));" in src
    assert "tma_launch_geometry(xp, layout, 1, 2 * max(1, 4 // itemsize))" in _py_source(
        "ops/mass.py")


def test_point_only_ablation_patches_one_line():
    """profile_step --ablate replaces the stencil line of kernels A and C
    (rk4_tiled.cu), D (rk_stage_tiled.cu), E (slab_tiled.cu), H/I
    (lf_tiled.cu) and J's boundary (rk42_tiled.cu), and G's z and y
    contractions (mass_tiled.cu), by the point value in a copy of the
    sources, and takes D's, E's, G's, H/I's, J's and K's
    (general_kernels.cu) other parts out the same way; each line it
    replaces is there once."""
    from wave_fenics_tpu_torch.apps.profile_step import ABLATIONS, POINT_ONLY

    assert sorted(POINT_ONLY) == ["flat_tiled.cu", "lf_tiled.cu", "mass_tiled.cu",
                                  "rk42_tiled.cu", "rk4_tiled.cu", "rk_stage_tiled.cu",
                                  "slab_tiled.cu", "stiffness_tiled.cu"]
    assert sorted(a for a, ps in ABLATIONS.items() if "general_kernels.cu" in ps) == [
        "K gather only", "K no geometry", "K no overlap", "K no y read"]
    for patches in ABLATIONS.values():
        for name, (line, patch) in patches.items():
            assert _c_source(name).count(line) == 1 and line != patch


# The TMA kernels' layouts: E on the 3D slab (z aligned to 128, tile 16),
# D on the flat layout (z aligned to 16, the step path's tile), each at the
# cells of P12 (26x13x13: (304, 152, 256) at p = 10), of P4 (32x16x16:
# (304, 152, 160) at p = 8) and of a ragged (5,3,3) grid.
TMA_CELLS = [(26, 13, 13), (32, 16, 16), (5, 3, 3)]


def _tma_layout(kernel, cells, p):
    shape = tuple(c * p + 1 for c in cells)
    if kernel == "E":
        return PaddedLayout(shape, p, tile_x=16)
    return PaddedLayout(shape, p, tile_x=_flat_tile_x(p, 16), z_align=16)


def _tma_geometry(kernel, lay, itemsize):
    """Kernels B and E and the leapfrog phases of H and I take one TMA box
    of one field a plane, D two fields and two stage-input planes."""
    nf, extra = (2, 2) if kernel == "D" else (1, 0)
    return tiling.tma_geometry(lay, itemsize, fields=nf, extra=extra), nf, extra


def _flat_geometry(lay, itemsize):
    """Kernel B's launch tiling (flat_launch_args) on an H100."""
    x = torch.zeros(1, dtype=torch.float32 if itemsize == 4 else torch.float64)
    args = wave.flat_launch_args(x, x, lay, tuple(torch.zeros(1) for _ in range(5)))
    ty, tz, cx, gz, gy, gx, smem = args[-7:]
    return (gz, gy, gx), ty, tz, cx, smem


def _padding_count(lay):
    """How often csrc/stencil_tiled.cuh::for_each_padding visits each point:
    every point of an (x, y) row outside the interior rows, else the z
    points before h and from h + nz on."""
    Lx, Ly, _ = lay.padded_shape
    (x0, x1), (y0, y1), (z0, z1) = ((r.start, r.stop) for r in lay.interior)
    g, y = np.arange(Lx)[:, None], np.arange(Ly)[None, :]
    full = (g < x0) | (g >= x1) | (y < y0) | (y >= y1)
    count = np.zeros(lay.padded_shape, dtype=int)
    count[full] += 1
    count[~full, :z0] += 1
    count[~full, z1:] += 1
    return count


@pytest.mark.parametrize("cells", TMA_CELLS)
@pytest.mark.parametrize("kernel,p", [("E", p) for p in range(1, 11)]
                         + [("D", p) for p in range(1, 9)]
                         + [("H", p) for p in range(1, 9)]
                         + [("B", p) for p in range(1, 9)])
def test_tma_tiles_cover_the_interior_once(kernel, p, cells):
    """Kernel E's, D's, the leapfrog phases' (H, I) and kernel B's tiling
    (B's through its launcher's arguments): the tiles and x-chunks cover
    the interior
    exactly once and the padding pass the rest; every box starts 16-byte
    aligned along z, holds the tile's p-deep halo and stays within the TMA's
    256-point extents; the shared memory of a block stays within an H100's
    227 KB, and that of the blocks the launch bounds ask for within an SM's
    228 KB, in f32 and f64."""
    lay = _tma_layout(kernel, cells, p)
    Nx, Ny, Nz = lay.shape
    Lx, Ly, Lz = lay.padded_shape
    for itemsize in (4, 8):
        (gz, gy, gx), ty, tz, cx, smem = geo = _tma_geometry(kernel, lay, itemsize)[0]
        if kernel == "B":
            assert _flat_geometry(lay, itemsize) == geo
        W, BY, oz, box = tiling.tma_window(lay.h, p, ty, tz, itemsize)
        unit = 16 // itemsize
        assert ty * tz <= tiling.TILE_THREADS and tz <= tiling.TILE_Z and tz % unit == 0
        assert cx <= tiling.CHUNK_X_TMA[1] and W <= tiling.BOX_MAX and BY <= tiling.BOX_MAX
        assert W % unit == 0 and oz + tz + 2 * p <= W and BY == ty + 2 * p
        assert (W - tz) % 32 == 0  # a warp's taps in 32 distinct banks
        assert (Lz * itemsize) % 16 == 0
        for bz in range(gz):  # every tile's box starts on a 16-byte unit
            z_start = lay.h + bz * tz - p - oz
            assert z_start >= 0 and (z_start * itemsize) % 16 == 0
        assert smem <= SMEM_LIMIT
        assert tiling.tma_blocks_per_sm(itemsize) * (smem + SM_RESERVED) <= SM_SMEM
        # one layer of padding blocks beyond the x-chunks
        assert (gz, gy, gx) == (-(-Nz // tz), -(-Ny // ty), -(-Nx // cx) + 1)
        assert geo == _tma_geometry(kernel, lay, itemsize)[0]
    (gz, gy, gx), ty, tz, cx, _ = _tma_geometry(kernel, lay, 4)[0]
    ranges = [_axis_ranges(lay.x0, Nx, cx, gx - tiling.PADDING_LAYERS),
              _axis_ranges(lay.h, Ny, ty, gy), _axis_ranges(lay.h, Nz, tz, gz)]
    for (start, n, L), rs in zip(((lay.x0, Nx, Lx), (lay.h, Ny, Ly), (lay.h, Nz, Lz)),
                                 ranges):
        hits = np.zeros(L, dtype=int)
        for lo, hi in rs:
            assert lo < hi  # no empty tile
            hits[lo:hi] += 1
        assert (hits[start:start + n] == 1).all() and hits.sum() == n
        # the x taps and the y/z halo of every tile stay inside the state
        assert rs[0][0] - p >= 0 and rs[-1][1] + p <= L
    if np.prod(lay.padded_shape) <= 4_000_000:  # every point written once
        count = _padding_count(lay)
        for x in ranges[0]:
            for y in ranges[1]:
                for z in ranges[2]:
                    count[x[0]:x[1], y[0]:y[1], z[0]:z[1]] += 1
        assert (count == 1).all()


def test_tma_geometry_on_the_app_layouts():
    """P12 (kernel E, p = 10) and P4 (kernel D, p = 8) in f32: 28-wide z
    tiles (a multiple of the 16-byte unit) of 9 rows, 60-point box rows
    (28 + 32, for the banks), one wave of tile blocks at most two an SM."""
    e = _tma_layout("E", (26, 13, 13), 10)
    d = _tma_layout("D", (32, 16, 16), 8)
    assert e.padded_shape == (304, 152, 256) and d.padded_shape == (304, 152, 160)
    for lay, nf, W in ((e, "E", 60), (d, "D", 60)):
        (grid, ty, tz, cx, smem), *_ = _tma_geometry(nf, lay, 4)
        assert (ty, tz) == (9, 28) and tiling.tma_window(lay.h, lay.p, ty, tz, 4)[0] == W
        tiles = grid[0] * grid[1] * (grid[2] - tiling.PADDING_LAYERS)
        assert tiles <= tiling.tma_blocks_per_sm(4) * tiling.H100_SMS


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
    grid, ty, tz, cx, smem = _stage_geometry(lay, 3)
    first = int(stage_geometry(_tensor(), lay, 3)[5])
    assert args[-8:] == (ty, tz, cx, *grid, smem, first)
    flipped = stage_launch_args(3, *(_tensor() for _ in range(10)), 5, -1, 1e-9, 0.5,
                                1500.0, lay, st, padding_first=not first)
    assert flipped[:-1] == args[:-1] and flipped[-1] == 1 - first
    src = (Path(_cuda.CSRC) / "rk4_tiled.cu").read_text()
    proto = re.search(r'extern "C" int NAME##_##SUFFIX\((.*?)\)\s*\{', src, re.S)
    params = [q for q in proto.group(1).replace("\\", " ").split(",") if q.strip()]
    assert len(params) == len(sig)


@pytest.mark.parametrize("name", ["wave_apply_slab_tiled", "wave_rk_stage_tiled"])
def test_tma_launch_args_match_the_c_signature(name):
    """Kernels E's and D's wrappers build argument lists whose types are the
    ones ctypes declares for the launcher, ending in the tiling of
    tma_geometry, and the launcher's C prototype has as many parameters."""
    p = 4
    if name == "wave_apply_slab_tiled":
        lay = _tma_layout("E", (4, 2, 2), p)
        args = wave.slab_launch_args(_tensor(), _tensor(), lay,
                                     tuple(_tensor() for _ in range(6)))
        geo, src = _tma_geometry("E", lay, 4)[0], "slab_tiled.cu"
    else:
        lay = _tma_layout("D", (4, 2, 2), p)
        args = wave.rk_stage_launch_args(
            *(_tensor() for _ in range(10)), 1e-9, 5e-10, 0.5, lay, 1500.0,
            tuple(_tensor() for _ in range(5)), _tensor(), _tensor(), 17, -1)
        geo, src = _tma_geometry("D", lay, 4)[0], "rk_stage_tiled.cu"
    sig = _cuda._SIGNATURES[name]
    kinds = {ctypes.c_void_p: torch.Tensor, ctypes.c_int: int, ctypes.c_double: float}
    assert len(args) + 1 == len(sig) and sig[-1] is ctypes.c_void_p  # + stream
    for a, t in zip(args, sig):
        assert type(a) is kinds[t] or isinstance(a, kinds[t])
    grid, ty, tz, cx, smem = geo
    assert args[-7:] == (ty, tz, cx, *grid, smem)
    proto = re.search(r'extern "C" int wave_\w+##SUFFIX\((.*?)\)\s*\{', _c_source(src), re.S)
    params = [q for q in proto.group(1).replace("\\", " ").split(",") if q.strip()]
    assert len(params) == len(sig)


@pytest.mark.parametrize("phase", [0, 1, 2])
def test_lf_launch_args_match_the_c_signature(phase):
    """The leapfrog phases' argument lists (OPEN, MID, CLOSE: the same
    tiling, one TMA field; CLOSE passes a null u_out) have the types ctypes
    declares for ``wave_lf_phase_tiled``, end in tma_geometry's tiling, and
    the launcher's C prototype has as many parameters."""
    lay = _tma_layout("H", (4, 2, 2), 4)
    u_out = None if phase == lfstep.LF_CLOSE else _tensor()
    args = lfstep.lf_launch_args(phase, _tensor(), _tensor(), u_out, _tensor(), 1e-9,
                                 0.5, lay, 1500.0, tuple(_tensor() for _ in range(5)),
                                 _tensor(), _tensor(), 17, -1)
    sig = _cuda._SIGNATURES["wave_lf_phase_tiled"]
    kinds = {ctypes.c_void_p: (torch.Tensor, int), ctypes.c_int: int,
             ctypes.c_double: float}
    assert len(args) + 1 == len(sig) and sig[-1] is ctypes.c_void_p  # + stream
    for a, t in zip(args, sig):
        assert isinstance(a, kinds[t])
    assert args[0] == phase and (args[3] is u_out if u_out is not None else args[3] == 0)
    grid, ty, tz, cx, smem = _tma_geometry("H", lay, 4)[0]
    assert args[-8:] == (ty, tz, cx, *grid, smem, int(tiling.tma_padding_first(grid)))
    proto = re.search(r'extern "C" int wave_\w+##SUFFIX\((.*?)\)\s*\{',
                      _c_source("lf_tiled.cu"), re.S)
    params = [q for q in proto.group(1).replace("\\", " ").split(",") if q.strip()]
    assert len(params) == len(sig)
    assert re.search(r"enum LfPhase \{ kLfOpen = (\d), kLfMid = (\d), kLfClose = (\d) \}",
                     _c_source("lf_tiled.cu")).groups() == tuple(
        str(ph) for ph in (lfstep.LF_OPEN, lfstep.LF_MID, lfstep.LF_CLOSE))


@pytest.mark.parametrize("cells,p,first", [((64, 32, 32), 4, True), ((32, 16, 16), 8, False)])
def test_lf_padding_layer_order(cells, p, first):
    """The leapfrog kernels' padding layer goes first where the tile blocks
    take more than one wave of the H100's block slots (P2 at p = 4: 525
    tile blocks, 264 slots in f32) and last where they fit one (P3 at
    p = 8: 225), as tma_padding_first decides from the grid."""
    lay = _tma_layout("H", cells, p)
    (gz, gy, gx), *_ = _tma_geometry("H", lay, 4)[0]
    tiles = gz * gy * (gx - tiling.PADDING_LAYERS)
    slots = tiling.H100_SMS * tiling.tma_blocks_per_sm(4)
    assert (tiles > slots) == first == tiling.tma_padding_first((gz, gy, gx))
    assert tiles == (525 if first else 225)


@pytest.mark.parametrize("kernel", ["H", "I"])
def test_lf_wrappers_raise_on_cpu_tensors(kernel):
    """Kernels H's and I's CUDA wrappers take CUDA tensors only: a CPU
    tensor raises before any launch (the dispatchers send it to the plain
    version), and no launch is counted."""
    lay = _tma_layout("H", (4, 2, 2), 2)
    x = torch.zeros(lay.padded_shape, dtype=torch.float64)
    F = lay.padded_shape[1] * lay.padded_shape[2]
    st = tuple(torch.zeros(1) for _ in range(5))
    face = (lay, 1500.0, st, torch.zeros(1, F), torch.zeros(1, F), 3, -1)
    fn = lfstep.lf_step_cuda if kernel == "H" else lf2step.lf2_step_cuda
    n0 = fn.launches
    with pytest.raises(ValueError, match="CUDA kernel called with a tensor on cpu"):
        if kernel == "H":
            fn(x, x, 1e-9, 1.0, 0.5, *face)
        else:
            fn(x, x, 1e-9, 1.0, 0.5, 0.2, *face)
    assert fn.launches == n0


@pytest.mark.parametrize("call", ["slab", "stage"])
def test_tma_wrappers_raise_on_cpu_tensors(call):
    """The CUDA wrappers of kernels D and E take CUDA tensors only: a CPU
    tensor raises (the dispatchers send it to the plain version)."""
    lay = _tma_layout("E" if call == "slab" else "D", (2, 1, 1), 2)
    x = torch.zeros(lay.padded_shape, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA kernel called with a tensor on cpu"):
        if call == "slab":
            K, (Lx, Ly, Lz) = 5, lay.padded_shape
            tabs = (torch.zeros(1, Ly, Lz), torch.zeros(Lx, 1, Lz), torch.zeros(Lx, Ly, 1),
                    torch.zeros(K, Lx, 1, 1), torch.zeros(K, 1, Ly, 1),
                    torch.zeros(K, 1, 1, Lz))
            wave.apply_slab_cuda(x, lay, tabs)
        else:
            F = lay.padded_shape[1] * lay.padded_shape[2]
            wave.rk_stage_cuda(x, x, x, x, x, x, 0.0, 1e-9, 1.0, lay, 1500.0,
                               tuple(torch.zeros(1) for _ in range(5)),
                               torch.zeros(1, F), torch.zeros(1, F), 3, -1)


# Kernel G (csrc/mass_tiled.cu) on the BP1 layouts ops/mass.py::bp1_setup
# builds (z_align 16, tile 32 at p = 1, else 16): the P6 size (64^3 cells;
# (304, 272, 272) at p = 4) and two small grids, the second ragged against
# the tiling.
G_CELLS = [(64, 64, 64), (3, 2, 2), (5, 3, 4)]


def _mass_layout(cells, p):
    return mass.mass_layout(tuple(n * p + 1 for n in cells), p, 32 if p == 1 else 16)


def _mass_geometry(lay, itemsize):
    """kernel G's launch tiling (mass_launch_args) on an H100."""
    x = torch.zeros(1, dtype=torch.float32 if itemsize == 4 else torch.float64)
    args = mass.mass_launch_args(x, x, lay, tuple(torch.zeros(1) for _ in range(3)))
    ty, tz, cx, gz, gy, gx, smem = args[-7:]
    return (gz, gy, gx), ty, tz, cx, smem


def _covers_once(lay, grid, ty, tz, cx, p):
    """The tiles and x-chunks of a TMA grid cover the interior exactly once,
    every tap of a tile inside the state, and the padding pass the rest."""
    gz, gy, gx = grid
    Nx, Ny, Nz = lay.shape
    Lx, Ly, Lz = lay.padded_shape
    ranges = [_axis_ranges(lay.x0, Nx, cx, gx - tiling.PADDING_LAYERS),
              _axis_ranges(lay.h, Ny, ty, gy), _axis_ranges(lay.h, Nz, tz, gz)]
    for (start, n, L), rs in zip(((lay.x0, Nx, Lx), (lay.h, Ny, Ly), (lay.h, Nz, Lz)),
                                 ranges):
        hits = np.zeros(L, dtype=int)
        for lo, hi in rs:
            assert lo < hi  # no empty tile
            hits[lo:hi] += 1
        assert (hits[start:start + n] == 1).all() and hits.sum() == n
        assert rs[0][0] - p >= 0 and rs[-1][1] + p <= L
    if np.prod(lay.padded_shape) <= 4_000_000:  # every point written once
        count = _padding_count(lay)
        for x in ranges[0]:
            for y in ranges[1]:
                for z in ranges[2]:
                    count[x[0]:x[1], y[0]:y[1], z[0]:z[1]] += 1
        assert (count == 1).all()


@pytest.mark.parametrize("cells", G_CELLS)
@pytest.mark.parametrize("p", range(1, 9))
def test_mass_tiles_cover_the_interior_once(p, cells):
    """Kernel G's tiling: the tiles and x-chunks cover the interior of the
    BP1 layout exactly once and the padding pass the rest; every box
    starts 16-byte aligned along z (a misaligned TMA box start is an
    illegal instruction on the H100) and holds the tile's p-deep halo; the
    shared memory (the ring, two z-contracted planes and cvx of a chunk's
    rows) stays within a block's 227 KB in f32 and f64, p = 8 included."""
    lay = _mass_layout(cells, p)
    if cells == (64, 64, 64) and p == 4:
        assert lay.padded_shape == (304, 272, 272)
    if p == 1:
        assert lay.tile_x == 32
    Lz = lay.padded_shape[2]
    for itemsize in (4, 8):
        grid, ty, tz, cx, smem = _mass_geometry(lay, itemsize)
        W, BY, oz, box = tiling.tma_window(lay.h, p, ty, tz, itemsize)
        assert ty * tz <= tiling.TILE_THREADS and tz % (16 // itemsize) == 0
        assert W <= tiling.BOX_MAX and BY == ty + 2 * p and oz + tz + 2 * p <= W
        assert (Lz * itemsize) % 16 == 0
        for bz in range(grid[0]):
            z_start = lay.h + bz * tz - p - oz
            assert z_start >= 0 and (z_start * itemsize) % 16 == 0
        want = tiling.tma_smem_bytes((W, BY, oz, box), itemsize, 1, 2) \
            + (2 * p + 1) * cx * itemsize
        assert smem == want <= tiling.SMEM_LIMIT
    _covers_once(lay, grid, ty, tz, cx, p)


def test_mass_geometry_on_the_p6_layout():
    """P6 in f32: 32-wide z tiles of 8 rows (9 x 33 tiles of the 257^2
    interior columns), chunks of 43 rows and the padding layer (6 + 1
    layers), two blocks an SM within its shared memory."""
    lay = _mass_layout((64, 64, 64), 4)
    grid, ty, tz, cx, smem = _mass_geometry(lay, 4)
    assert (grid, ty, tz, cx) == ((9, 33, 7), 8, 32, 43)
    assert tiling.tma_blocks_per_sm(4) * (smem + SM_RESERVED) <= SM_SMEM


# Kernel J's step boundary on the layouts of the two-step path: the P1
# configuration (64x32x32 cells, tile 48) and (4,2,2) cells, each on the
# smallest tile >= the 6p halo the path allows (and at least 24).
J_CELLS = [((64, 32, 32), 48), ((4, 2, 2), 24)]


def _rk42_layout(cells, p, tile):
    return _layout(cells, p, max(tile, rk42step._off0(p)))


def _boundary_geometry(lay, itemsize):
    dt = torch.float32 if itemsize == 4 else torch.float64
    t = torch.zeros(1, dtype=dt)
    args = rk42step.boundary_launch_args(
        *(t for _ in range(10)), 17, -1, 1e-9, 0.5, 1500.0, lay,
        tuple(torch.zeros(1) for _ in range(5)))
    ty, tz, cx, gz, gy, gx, smem = args[-7:]
    return (gz, gy, gx), ty, tz, cx, smem


@pytest.mark.parametrize("cells,tile", J_CELLS)
@pytest.mark.parametrize("p", range(1, 9))
def test_boundary_tiles_cover_the_interior_once(p, cells, tile):
    """Kernel J's step-boundary tiling on tiles >= 6p: the interior exactly
    once, the padding pass the rest, 16-byte aligned box starts, and the
    shared memory of five input boxes a plane in a ring of boundary_ring
    planes and four formed planes within a block's 227 KB in f32 and f64;
    in f32 two blocks fit an SM at p <= 6."""
    lay = _rk42_layout(cells, p, tile)
    assert lay.tile_x >= 6 * p
    for itemsize in (4, 8):
        grid, ty, tz, cx, smem = _boundary_geometry(lay, itemsize)
        W, BY, oz, box = window = tiling.tma_window(lay.h, p, ty, tz, itemsize)
        assert tz % (16 // itemsize) == 0 and W <= tiling.BOX_MAX and BY <= tiling.BOX_MAX
        for bz in range(grid[0]):
            assert ((lay.h + bz * tz - p - oz) * itemsize) % 16 == 0
        ring = rk42step.boundary_ring(itemsize)
        assert smem == tiling.tma_smem_bytes(window, itemsize, 5, 4, ring) <= tiling.SMEM_LIMIT
        if itemsize == 4 and p <= 6:
            assert tiling.tma_blocks_per_sm(4) * (smem + SM_RESERVED) <= SM_SMEM
    _covers_once(lay, grid, ty, tz, cx, p)


def test_mass_launch_args_match_the_c_signature():
    """Kernel G's wrapper builds an argument list whose types are the ones
    ctypes declares for ``wave_mass_tiled``, ending in the tiling, and the
    launcher's C prototype has as many parameters."""
    lay = _mass_layout((3, 2, 2), 4)
    args = mass.mass_launch_args(_tensor(), _tensor(), lay,
                                 tuple(_tensor() for _ in range(3)))
    sig = _cuda._SIGNATURES["wave_mass_tiled"]
    kinds = {ctypes.c_void_p: torch.Tensor, ctypes.c_int: int, ctypes.c_double: float}
    assert len(args) + 1 == len(sig) and sig[-1] is ctypes.c_void_p  # + stream
    for a, t in zip(args, sig):
        assert type(a) is kinds[t] or isinstance(a, kinds[t])
    grid, ty, tz, cx, smem = _mass_geometry(lay, 4)
    assert args[-7:] == (ty, tz, cx, *grid, smem)
    proto = re.search(r'extern "C" int wave_\w+##SUFFIX\((.*?)\)\s*\{',
                      _c_source("mass_tiled.cu"), re.S)
    params = [q for q in proto.group(1).replace("\\", " ").split(",") if q.strip()]
    assert len(params) == len(sig)


def test_boundary_launch_args_match_the_c_signature():
    """Kernel J's step-boundary argument list has the types ctypes declares
    for ``wave_rk42_boundary_tiled``, ends in the tiling, and the
    launcher's C prototype has as many parameters."""
    lay = _rk42_layout((4, 2, 2), 4, 24)
    args = rk42step.boundary_launch_args(
        *(_tensor() for _ in range(10)), 17, -1, 1e-9, 0.5, 1500.0, lay,
        tuple(_tensor() for _ in range(5)))
    sig = _cuda._SIGNATURES["wave_rk42_boundary_tiled"]
    kinds = {ctypes.c_void_p: torch.Tensor, ctypes.c_int: int, ctypes.c_double: float}
    assert len(args) + 1 == len(sig) and sig[-1] is ctypes.c_void_p  # + stream
    for a, t in zip(args, sig):
        assert type(a) is kinds[t] or isinstance(a, kinds[t])
    grid, ty, tz, cx, smem = _boundary_geometry(lay, 4)
    assert args[-7:] == (ty, tz, cx, *grid, smem)
    proto = re.search(r'extern "C" int wave_\w+##SUFFIX\((.*?)\)\s*\{',
                      _c_source("rk42_tiled.cu"), re.S)
    params = [q for q in proto.group(1).replace("\\", " ").split(",") if q.strip()]
    assert len(params) == len(sig)


@pytest.mark.parametrize("kernel", ["G", "J", "J boundary"])
def test_g_and_j_wrappers_raise_on_cpu_tensors(kernel):
    """Kernel G's and J's CUDA wrappers (and the checks' launch of J's step
    boundary alone) take CUDA tensors only: a CPU tensor raises before any
    launch (the dispatchers send it to the plain version), and no launch
    is counted (the boundary's launches are counted by kernel J's)."""
    counter = None
    if kernel == "G":
        lay, tabs, _ = mass.bp1_setup(box_mesh((3, 2, 2), (1.0, 0.8, 1.2)), 2,
                                      torch.float64, torch.device("cpu"))
        fn = mass.mass_apply_cuda
        call = lambda: fn(torch.zeros(lay.padded_shape, dtype=torch.float64), lay, tabs)  # noqa: E731
    else:
        lay = _rk42_layout((4, 2, 2), 2, 24)
        x = torch.zeros(lay.padded_shape, dtype=torch.float64)
        F = lay.padded_shape[1] * lay.padded_shape[2]
        face = (lay, 1500.0, tuple(torch.zeros(1) for _ in range(5)), torch.zeros(1, F),
                torch.zeros(1, F), 3, -1)
        if kernel == "J":
            fn = rk42step.rk42_step_cuda
            call = lambda: fn(x, x, 1e-9, (1.0,) * 5, *face)  # noqa: E731
        else:
            fn, counter = rk42step._rk42_boundary_cuda, rk42step.rk42_step_cuda
            call = lambda: fn(x, x, x, x, x, 1e-9, 0.5, *face)  # noqa: E731
    counter = counter or fn
    n0 = counter.launches
    with pytest.raises(ValueError, match="CUDA kernel called with a tensor on cpu"):
        call()
    assert counter.launches == n0


def test_tma_launch_check_names_the_unmet_condition():
    """No fallback: a layout kernels G and J cannot tile raises a ValueError
    that names the condition, before any launch: p above 8, a padded z
    row that is no multiple of 16 bytes, too shallow a padding, too much
    shared memory."""
    t32 = torch.zeros(1, dtype=torch.float32)
    tabs = tuple(torch.zeros(1) for _ in range(3))
    with pytest.raises(ValueError, match="p <= 8"):
        mass.mass_launch_args(t32, t32, PaddedLayout((19, 19, 19), 9, z_align=16), tabs)
    odd = PaddedLayout((9, 9, 9), 2, tile_x=16, z_align=1)  # Lz = 13
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        mass.mass_launch_args(t32, t32, odd, tabs)
    shallow = PaddedLayout((9, 9, 9), 4, tile_x=2, z_align=16)
    with pytest.raises(ValueError, match="must be >= p"):
        tiling.check_tma_launch(shallow, 4, 8, 16, 1024)
    lay = _mass_layout((3, 2, 2), 4)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        tiling.check_tma_launch(lay, 8, 8, 16, tiling.SMEM_LIMIT + 1)


# Kernel F (csrc/stiffness_tiled.cu) on the unpadded dof grid: the P7 grid
# (257^3), the ragged Nx = 17 of the JAX tests ((4,2,3) cells at p = 4:
# 17 x 9 x 13), and (4,2,3)- and (5,3,4)-cell grids at each degree.
def _f_shapes(p):
    return [(257, 257, 257), (17, 9, 13)] + [tuple(c * p + 1 for c in cells)
                                             for cells in ((4, 2, 3), (5, 3, 4))]


def _f_geometry(shape, p, itemsize):
    """Kernel F's launch tiling (stiffness_launch_args) on an H100."""
    x = torch.zeros(shape, dtype=torch.float32 if itemsize == 4 else torch.float64)
    args = stiffness.stiffness_launch_args(x, x, tuple(torch.zeros(1) for _ in range(6)), p)
    assert args[8:12] == (p, *shape)
    ty, tz, cx, gz, gy, gx, smem = args[-7:]
    return (gz, gy, gx), ty, tz, cx, smem


@pytest.mark.parametrize("p", range(1, 11))
def test_grid_tiles_cover_the_grid_once(p):
    """Kernel F's tiling at every degree it takes: the tiles and x-chunks
    cover every grid point exactly once (no padding, so no padding pass);
    the p warm-up planes of a chunk and the y/z halo of a tile may leave
    the grid, where the cp.async window reads zeros; the shared memory the
    launch asks for holds the kPipe-plane ring and the offset table of the
    (ty + 2p) x (tz + 2p) window, within a block's 227 KB and, for the
    blocks the launch bounds ask for, within an SM's 228 KB, in f32 and
    f64; the chunks fill the card's block slots."""
    for shape in _f_shapes(p):
        Nx, Ny, Nz = shape
        for itemsize in (4, 8):
            grid, ty, tz, cx, smem = _f_geometry(shape, p, itemsize)
            assert (grid, ty, tz, cx, smem) == tiling.grid_geometry(shape, p, itemsize)
            rows = tiling.grid_rows(itemsize, p)
            assert ty % rows == 0 and tz % rows == 0
            assert ty // rows * tz <= tiling.TILE_THREADS and tz <= tiling.TILE_Z
            # the window's pitch: a warp's 32 tap loads in 32 banks
            W = tiling.grid_pitch(tz, p, rows)
            assert W >= tz + 2 * p and (rows * W - tz) % 32 == 0
            nt = ty // rows * tz
            for j in range(2 * p + rows):  # the rows a thread reads
                for t0 in range(0, nt, 32):  # each warp
                    banks = {((rows * (t // tz) + j) * W + t % tz) % 32
                             for t in range(t0, min(t0 + 32, nt))}
                    assert len(banks) == min(32, nt - t0)
            assert cx <= tiling.CHUNK_X_TMA[1]
            assert smem == (tiling.PIPE * (ty + 2 * p) * W * itemsize
                            + 8 * (ty + 2 * p) * (tz + 2 * p))
            assert smem <= tiling.SMEM_LIMIT
            assert tiling.tma_blocks_per_sm(itemsize) * (smem + SM_RESERVED) <= SM_SMEM
            assert grid == (-(-Nz // tz), -(-Ny // ty), -(-Nx // cx))
        ranges = [_axis_ranges(0, Nx, cx, grid[2]), _axis_ranges(0, Ny, ty, grid[1]),
                  _axis_ranges(0, Nz, tz, grid[0])]
        for n, rs in zip(shape, ranges):
            hits = np.zeros(n, dtype=int)
            for lo, hi in rs:
                assert lo < hi  # no empty tile or chunk
                hits[lo:hi] += 1
            assert (hits == 1).all()
        if np.prod(shape) <= 1_000_000:  # the whole grid, point by point
            count = np.zeros(shape, dtype=int)
            for x in ranges[0]:
                for y in ranges[1]:
                    for z in ranges[2]:
                        count[x[0]:x[1], y[0]:y[1], z[0]:z[1]] += 1
            assert (count == 1).all()


def test_grid_geometry_on_the_p7_grid():
    """P7 in f32 (257^3, p = 4): 30-wide z tiles of 16 rows, two a thread
    (9 x 17 tiles of 240 threads; the window's pitch 47), five x-chunks of
    52 rows: 765 blocks, under three waves of the two blocks an SM the
    launch bounds ask for; cached (every apply asks). In f64 one row a
    thread: tiles of 8 x 29."""
    geo = tiling.grid_geometry((257, 257, 257), 4, 4)
    assert geo == ((9, 17, 5), 16, 30, 52, 25_344)
    assert tiling.grid_pitch(30, 4, 2) == 47
    assert tiling.grid_geometry((257, 257, 257), 4, 4) is geo
    assert 9 * 17 * 5 <= 3 * tiling.tma_blocks_per_sm(4) * tiling.H100_SMS
    assert tiling.grid_geometry((257, 257, 257), 4, 8)[1:3] == (8, 29)


def test_flat_geometry_on_the_p1_layout():
    """Kernel B at the P1 layout ((384, 144, 144), p = 4, f32): the tiling
    of the leapfrog kernels on the same layout (28-wide z tiles of 9 rows,
    7 chunks of 37 rows: 525 tile blocks and one layer of 75 padding
    blocks), the box 16-byte aligned."""
    lay = _tma_layout("B", (64, 32, 32), 4)
    lay = PaddedLayout(lay.shape, 4, tile_x=48, z_align=16)
    assert lay.padded_shape == (384, 144, 144)
    grid, ty, tz, cx, _ = _flat_geometry(lay, 4)
    assert (grid, ty, tz, cx) == ((5, 15, 8), 9, 28, 37)
    assert grid[0] * grid[1] * (grid[2] - tiling.PADDING_LAYERS) == 525


def test_flat_and_grid_launch_args_match_the_c_signature():
    """Kernels B's and F's wrappers build argument lists whose types are the
    ones ctypes declares for ``wave_apply_flat_tiled`` and
    ``wave_stiffness_tiled``, ending in their tilings, and each launcher's C
    prototype has as many parameters."""
    kinds = {ctypes.c_void_p: torch.Tensor, ctypes.c_int: int, ctypes.c_double: float}
    lay = _tma_layout("B", (4, 2, 2), 4)
    flat = wave.flat_launch_args(_tensor(), _tensor(), lay,
                                 tuple(_tensor() for _ in range(5)))
    (gz, gy, gx), ty, tz, cx, smem = _tma_geometry("B", lay, 4)[0]
    assert flat[-7:] == (ty, tz, cx, gz, gy, gx, smem)
    x = torch.zeros((9, 5, 7))
    grid = stiffness.stiffness_launch_args(x, x, tuple(_tensor() for _ in range(6)), 2)
    (fz, fy, fx), ty, tz, cx, smem = tiling.grid_geometry((9, 5, 7), 2)
    assert grid[-7:] == (ty, tz, cx, fz, fy, fx, smem)
    for name, args, src in (("wave_apply_flat_tiled", flat, "flat_tiled.cu"),
                            ("wave_stiffness_tiled", grid, "stiffness_tiled.cu")):
        sig = _cuda._SIGNATURES[name]
        assert len(args) + 1 == len(sig) and sig[-1] is ctypes.c_void_p  # + stream
        for a, t in zip(args, sig):
            assert type(a) is kinds[t] or isinstance(a, kinds[t])
        proto = re.search(r'extern "C" int wave_\w+##SUFFIX\((.*?)\)\s*\{', _c_source(src),
                          re.S)
        params = [q for q in proto.group(1).replace("\\", " ").split(",") if q.strip()]
        assert len(params) == len(sig)


@pytest.mark.parametrize("kernel", ["B", "F"])
def test_flat_and_grid_wrappers_raise_on_cpu_tensors(kernel):
    """Kernels B's and F's CUDA wrappers take CUDA tensors only: a CPU
    tensor raises before any launch (the dispatchers send it to the plain
    version), and no launch is counted."""
    if kernel == "B":
        lay = _tma_layout("B", (2, 1, 1), 2)
        x = torch.zeros(lay.padded_shape, dtype=torch.float64)
        fn = wave.apply_flat_cuda
        call = lambda: fn(x, lay, tuple(torch.zeros(1) for _ in range(5)))  # noqa: E731
    else:
        x = torch.zeros((5, 3, 3), dtype=torch.float64)
        fn = stiffness.stiffness_grid_cuda
        tabs = stiffness.GridStiffnessTables(*(torch.zeros(1) for _ in range(6)))
        call = lambda: fn(x, tabs, 2)  # noqa: E731
    n0 = fn.launches
    with pytest.raises(ValueError, match="CUDA kernel called with a tensor on cpu"):
        call()
    assert fn.launches == n0


def test_flat_and_grid_launch_checks_name_the_unmet_condition():
    """No fallback: a degree or layout kernels B and F cannot take raises a
    ValueError that names the condition, before any launch: F outside
    1 <= p <= 10, B above p = 8 or on a layout the flat kernels do not
    take. (A flat layout's Ly * Lz is a multiple of 128 and Ly of 8, so its
    z rows are whole 16-byte units, as the TMA box needs.)"""
    t32 = torch.zeros((9, 9, 9), dtype=torch.float32)
    tabs = tuple(torch.zeros(1) for _ in range(6))
    for p in (0, 11):
        with pytest.raises(ValueError, match="1 <= p <= 10"):
            stiffness.stiffness_launch_args(t32, t32, tabs, p)
    st = tuple(torch.zeros(1) for _ in range(5))
    with pytest.raises(ValueError, match="p <= 8"):
        wave.flat_launch_args(t32, t32, PaddedLayout((19, 19, 19), 9, z_align=16), st)
    with pytest.raises(ValueError, match="multiple of 8"):
        wave.flat_launch_args(t32, t32, PaddedLayout((9, 9, 9), 2, tile_x=12,
                                                     z_align=16), st)
