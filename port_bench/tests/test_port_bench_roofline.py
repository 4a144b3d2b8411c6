"""The roofline counts, pinned to hand-worked values at the cells' sizes,
and counted from the problem alone."""

import inspect
import json

import pytest

from port_bench import harness, roofline

STIFFNESS_CELL = 6 * 5 ** 4 + 6 * 5 ** 3  # 4,500 operations a cell at p = 4 on the box
MASS_CELL = 4 * (6 * 125 + 36 * 25 + 216 * 5) + 216 + 125  # 11,261 at p = 4, 6 points


@pytest.mark.parametrize("workload, flops, nbytes", [
    # four stiffness applies on 64 x 32 x 32 cells; u and v in and out, f32
    ("planar3d-p4.rk4", 4 * 65536 * STIFFNESS_CELL, 4276737 * 16),
    # one apply a step
    ("planar3d-p4.leapfrog", 65536 * STIFFNESS_CELL, 4276737 * 16),
    # one Gauss mass on 64^3 cells; x, r, p in and out, the matvec's in and out
    ("bp1-p4-s18.cg", 262144 * MASS_CELL, 16974593 * 32),
])
def test_unit_work_is_pinned(workload, flops, nbytes):
    cell = harness.load_cell(workload)
    assert roofline.unit_work(cell.config, cell.traffic) == (flops, nbytes)
    assert roofline.ndofs(cell.config["cells"], cell.config["degree"]) == cell.config["ndofs"]


def test_least_times_at_the_h100_peaks():
    rk4 = harness.load_cell("planar3d-p4.rk4")
    cg = harness.load_cell("bp1-p4-s18.cg")
    # RK4: bound by bytes, 68.4 MB at 3.35 TB/s (operations alone: 1.18 GFLOP, 17.6 us)
    assert 4 * 65536 * STIFFNESS_CELL / 67e12 < 4276737 * 16 / 3.35e12
    assert roofline.least_time_s(rk4.config, rk4.traffic, "NVIDIA H100 80GB HBM3") == \
        pytest.approx(4276737 * 16 / 3.35e12)
    # CG: bound by bytes, 543 MB at 3.35 TB/s
    assert roofline.least_time_s(cg.config, cg.traffic, "NVIDIA H100 80GB HBM3") == \
        pytest.approx(16974593 * 32 / 3.35e12)
    assert roofline.least_time_s(cg.config, cg.traffic, "cpu") is None


def test_count_takes_nothing_of_the_port_layout():
    """The counts read the configuration's cells, p, Gauss points and dtype
    and the traffic's unit: a padded layout's extents change nothing."""
    assert list(inspect.signature(roofline.unit_work).parameters) == ["config", "traffic"]
    cell = harness.load_cell("planar3d-p4.rk4")
    padded = {**cell.config, "padded_shape": [384, 144, 144], "tile_x": 48}
    assert roofline.unit_work(padded, cell.traffic) == roofline.unit_work(cell.config, cell.traffic)
    _, nbytes = roofline.unit_work(cell.config, cell.traffic)
    assert nbytes != 384 * 144 * 144 * 16
    assert "wave_fenics_tpu_torch" not in inspect.getsource(roofline)


def test_traffic_files_hold_their_counts():
    for path in (harness.ROOT / "traffic").glob("*.json"):
        r = json.loads(path.read_text())["roofline"]
        assert r["per"] in ("step", "iter") and r["applies"] >= 1 and r["why"]


def test_operators_are_found_by_name():
    """Each operator's count is a file of ``operators/``, which the roofline
    finds by the configuration's ``operator`` and does not name; an
    unknown operator names the file to add."""
    source = inspect.getsource(roofline)
    stems = [p.stem for p in roofline.OPERATORS.glob("*.py")]
    assert stems and not any(s in source for s in stems)
    config = {**harness.load_cell("planar3d-p4.rk4").config, "operator": "no_such_operator"}
    with pytest.raises(ValueError, match=r"operators/no_such_operator\.py"):
        roofline.apply_flops(config)
