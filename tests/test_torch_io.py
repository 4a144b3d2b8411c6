"""The port's XDMF I/O (core/io.py) and StructuredDofGrid against the JAX
package's on the same meshes and fields (CPU, float64).

Readers: the port's and the JAX package's on XML and HDF files (the JAX
tests' h5py layout, and the port's own writers), and the port's on its
binary files: points, cells and tags ``array_equal``. Writers: each port
writer with ``data_format="hdf"`` against the JAX writer on the same
fields (every dataset ``array_equal``, the XDMF parsed to the same element
tree), and the binary format read back exactly. Meshes come from the port's
``general_solve.perturbed_box`` (seeded), so they are not affine."""

import sys
import xml.etree.ElementTree as ET

import h5py
import numpy as np
import pytest

import _torch_cases  # noqa: F401  (one torch thread per test process)
from wave_fenics_tpu.core import io as jio
from wave_fenics_tpu.core.dofmap import StructuredDofGrid as JStructuredDofGrid
from wave_fenics_tpu.core.dofmap import build_dofmap as jbuild_dofmap
from wave_fenics_tpu.core.mesh import HexMesh as JHexMesh
from wave_fenics_tpu.core.mesh import box_mesh as jbox_mesh
from wave_fenics_tpu_torch.benchmarks.general_solve import perturbed_box
from wave_fenics_tpu_torch.core import io
from wave_fenics_tpu_torch.core.dofmap import StructuredDofGrid, build_dofmap
from wave_fenics_tpu_torch.core.mesh import HexMesh, box_mesh
from wave_fenics_tpu_torch.models.general_wave import check_exterior_facets

CELLS = (3, 2, 2)


def _mesh_and_tags():
    hm, tags = perturbed_box(CELLS, h=0.002)
    facets = np.concatenate([tags[1], tags[2]])
    values = np.array([1] * len(tags[1]) + [2] * len(tags[2]), np.int32)
    return hm, facets, values


def _write_h5_pair(d, hm, facets, values):
    """mesh.xdmf + tags.xdmf over one HDF5 file, as the JAX tests write them
    (tests/test_general_wave.py::_write_planar_xdmf)."""
    with h5py.File(d / "m.h5", "w") as f:
        f["/geom"] = hm.points
        f["/topo"] = hm.cells[:, [0, 1, 3, 2, 4, 5, 7, 6]]
        f["/ftopo"] = facets[:, [0, 1, 3, 2]]
        f["/fvals"] = values
    n, nf, npt = hm.ncells, len(facets), len(hm.points)
    (d / "mesh.xdmf").write_text(f"""<?xml version="1.0"?>
<Xdmf Version="3.0"><Domain><Grid Name="planar3d">
<Topology TopologyType="Hexahedron" NumberOfElements="{n}">
<DataItem Dimensions="{n} 8" Format="HDF">m.h5:/topo</DataItem></Topology>
<Geometry GeometryType="XYZ">
<DataItem Dimensions="{npt} 3" Format="HDF">m.h5:/geom</DataItem></Geometry>
</Grid></Domain></Xdmf>""")
    (d / "tags.xdmf").write_text(f"""<?xml version="1.0"?>
<Xdmf Version="3.0"><Domain><Grid Name="planar3d_boundaries">
<Topology TopologyType="Quadrilateral" NumberOfElements="{nf}">
<DataItem Dimensions="{nf} 4" Format="HDF">m.h5:/ftopo</DataItem></Topology>
<Attribute Name="tags" Center="Cell">
<DataItem Dimensions="{nf}" Format="HDF">m.h5:/fvals</DataItem></Attribute>
</Grid></Domain></Xdmf>""")


def _write_pair(d, fmt):
    """(mesh, facets, values) written to d/mesh.xdmf and d/tags.xdmf in
    ``fmt``: 'h5' (the JAX tests' layout) or a port data_format."""
    hm, facets, values = _mesh_and_tags()
    d.mkdir(exist_ok=True)
    if fmt == "h5":
        _write_h5_pair(d, hm, facets, values)
    else:
        io.write_xdmf_mesh(str(d / "mesh.xdmf"), hm, data_format=fmt)
        io.write_xdmf_meshtags(str(d / "tags.xdmf"), hm, facets, values, data_format=fmt)
    return hm, facets, values


@pytest.mark.parametrize("fmt", ["h5", "xml", "hdf"])
def test_readers_match_jax(tmp_path, fmt):
    """Exact: the port's and the JAX package's readers give the same points,
    cells, facets and tags, and both give back the written mesh."""
    hm, facets, values = _write_pair(tmp_path, fmt)
    m, jm = io.read_xdmf(str(tmp_path / "mesh.xdmf")), jio.read_xdmf(str(tmp_path / "mesh.xdmf"))
    for a, b in ((m.points, jm.points), (m.cells, jm.cells), (m.points, hm.points),
                 (m.cells, hm.cells)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    f, v = io.read_xdmf_meshtags(str(tmp_path / "tags.xdmf"))
    jf, jv = jio.read_xdmf_meshtags(str(tmp_path / "tags.xdmf"))
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f[:, [0, 1, 3, 2]], facets)
    np.testing.assert_array_equal(v, values)


def test_binary_mesh_round_trip(tmp_path):
    """Exact: the port's binary files read back as the written mesh and tags,
    in the dtypes the JAX package writes (int64 topology, float64 points,
    int32 tags)."""
    hm, facets, values = _write_pair(tmp_path, "binary")
    m = io.read_xdmf(str(tmp_path / "mesh.xdmf"))
    np.testing.assert_array_equal(m.points, hm.points)
    np.testing.assert_array_equal(m.cells, hm.cells)
    f, v = io.read_xdmf_meshtags(str(tmp_path / "tags.xdmf"))
    np.testing.assert_array_equal(f[:, [0, 1, 3, 2]], facets)
    np.testing.assert_array_equal(v, values)
    root = ET.parse(tmp_path / "mesh.xdmf").getroot()
    kinds = {i.text.strip(): (i.get("NumberType"), i.get("Precision"), i.get("Endian"))
             for i in root.iter("DataItem")}
    assert kinds == {"mesh.topo.bin": ("Int", "8", "Little"),
                     "mesh.geom.bin": ("Float", "8", "Little")}


def test_npz_crosses_between_packages(tmp_path):
    hm, facets, values = _mesh_and_tags()
    jm = JHexMesh(points=hm.points, cells=hm.cells, facets=facets, facet_tag_values=values)
    jio.save_npz(str(tmp_path / "j.npz"), jm)
    m = io.load_npz(str(tmp_path / "j.npz"))
    for name in ("points", "cells", "facets", "facet_tag_values"):
        np.testing.assert_array_equal(getattr(m, name), getattr(jm, name))
    io.save_npz(str(tmp_path / "p.npz"), HexMesh(points=hm.points, cells=hm.cells))
    back = jio.load_npz(str(tmp_path / "p.npz"))
    np.testing.assert_array_equal(back.points, hm.points)
    np.testing.assert_array_equal(back.cells, hm.cells)
    assert back.facets is None and back.facet_tag_values is None


def _tree(path):
    def norm(e):
        return (e.tag, dict(e.attrib), (e.text or "").strip(), [norm(c) for c in e])

    return norm(ET.parse(path).getroot())


def _datasets(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda n, o: out.__setitem__(n, np.asarray(o))
                     if isinstance(o, h5py.Dataset) else None)
    return out


def _assert_same_files(tmp_path):
    assert _tree(tmp_path / "jax" / "out.xdmf") == _tree(tmp_path / "port" / "out.xdmf")
    jd, pd = _datasets(tmp_path / "jax" / "out.h5"), _datasets(tmp_path / "port" / "out.h5")
    assert sorted(jd) == sorted(pd)
    for name in jd:
        np.testing.assert_array_equal(pd[name], jd[name])
        assert pd[name].dtype == jd[name].dtype, name


def _grid_fields(shape, seed):
    rng = np.random.default_rng(seed)
    return {"u": rng.standard_normal(shape), "v": rng.standard_normal(shape)}


def _rect_axes(p=3):
    dg = StructuredDofGrid(box_mesh((3, 2, 2), (0.01, 0.005, 0.006)), p)
    return tuple(dg.axis_coords(d) for d in range(3)), dg.grid_shape


def _write(tmp_path, which, fn, *args, **kw):
    d = tmp_path / which
    d.mkdir(exist_ok=True)
    fn(str(d / "out.xdmf"), *args, **kw)
    return d / "out.xdmf"


def test_rectilinear_writer_matches_jax(tmp_path):
    axes, shape = _rect_axes()
    fields = _grid_fields(shape, 1)
    _write(tmp_path, "jax", jio.write_xdmf_rectilinear, axes, fields, time=1.25e-6)
    _write(tmp_path, "port", io.write_xdmf_rectilinear, axes, fields, time=1.25e-6,
           data_format="hdf")
    _assert_same_files(tmp_path)


def test_time_series_writer_matches_jax(tmp_path):
    axes, shape = _rect_axes()
    snaps = [(k * 1e-7, _grid_fields(shape, k)) for k in range(3)]
    _write(tmp_path, "jax", jio.write_xdmf_time_series, axes, snaps)
    _write(tmp_path, "port", io.write_xdmf_time_series, axes, snaps, data_format="hdf")
    _assert_same_files(tmp_path)


def _dof_pair(p):
    hm, _, _ = _mesh_and_tags()
    jm = JHexMesh(points=hm.points, cells=hm.cells)
    return build_dofmap(hm, p), jbuild_dofmap(jm, p)


@pytest.mark.parametrize("p", [2, 3])
def test_unstructured_writer_matches_jax(tmp_path, p):
    dofs, jdofs = _dof_pair(p)
    fields = _grid_fields((dofs.ndofs,), p)
    _write(tmp_path, "jax", jio.write_xdmf_unstructured, jdofs, fields, time=3e-6)
    _write(tmp_path, "port", io.write_xdmf_unstructured, dofs, fields, time=3e-6,
           data_format="hdf")
    _assert_same_files(tmp_path)


@pytest.mark.parametrize("p", [2, 3])
def test_unstructured_binary_reads_back_as_a_mesh(tmp_path, p):
    """The binary sub-hex file is a valid mesh file: its points are the dof
    coordinates, its cells the sub-hexes in basix order (the JAX layout's
    topology, VTK-wound, permuted), and its fields read back exactly."""
    dofs, _ = _dof_pair(p)
    fields = _grid_fields((dofs.ndofs,), 7)
    path = _write(tmp_path, "port", io.write_xdmf_unstructured, dofs, fields)
    m = io.read_xdmf(str(path))
    np.testing.assert_array_equal(m.points, dofs.dof_coords)
    topo = io.sub_hex_topology(dofs.dofmap, p)
    np.testing.assert_array_equal(m.cells, topo[:, [0, 1, 3, 2, 4, 5, 7, 6]])
    assert m.ncells == dofs.ncells * p**3
    back = io.read_xdmf_attributes(str(path))
    for name, arr in fields.items():
        np.testing.assert_array_equal(back[name], arr)
        assert back[name].dtype == np.float64


def test_binary_rectilinear_and_series_read_back(tmp_path):
    axes, shape = _rect_axes()
    fields = _grid_fields(shape, 3)
    path = _write(tmp_path, "rect", io.write_xdmf_rectilinear, axes, fields, time=2e-6)
    back = io.read_xdmf_attributes(str(path))
    for name, arr in fields.items():
        np.testing.assert_array_equal(back[name], arr)
    z, y, x = io.read_xdmf_geometry(str(path))
    for a, b in zip((x, y, z), axes):
        np.testing.assert_array_equal(a, b)
    snaps = [(k * 1e-7, _grid_fields(shape, 10 + k)) for k in range(2)]
    path = _write(tmp_path, "series", io.write_xdmf_time_series, axes, snaps)
    for k, (_, f) in enumerate(snaps):
        back = io.read_xdmf_attributes(str(path), f"t{k}")
        for name, arr in f.items():
            np.testing.assert_array_equal(back[name], arr)


def test_jax_reader_reads_the_port_mesh_writer(tmp_path):
    """The port's inline-XML mesh and meshtags files load in the JAX package
    and build the same model tables there as the port's reader gives."""
    hm, facets, values = _write_pair(tmp_path, "xml")
    jm = jio.read_xdmf(str(tmp_path / "mesh.xdmf"))
    np.testing.assert_array_equal(jm.points, hm.points)
    np.testing.assert_array_equal(jm.cells, hm.cells)
    jf, jv = jio.read_xdmf_meshtags(str(tmp_path / "tags.xdmf"))
    np.testing.assert_array_equal(jf[:, [0, 1, 3, 2]], facets)
    np.testing.assert_array_equal(jv, values)


@pytest.mark.parametrize("p", [1, 2, 3, 4, 7])
def test_structured_dof_grid_bit_equal(p):
    mesh = box_mesh((3, 2, 4), (0.01, 0.004, 0.007), origin=(0.001, -0.002, 0.0))
    jmesh = jbox_mesh((3, 2, 4), (0.01, 0.004, 0.007), origin=(0.001, -0.002, 0.0))
    dg, jdg = StructuredDofGrid(mesh, p), JStructuredDofGrid(jmesh, p)
    assert dg.grid_shape == jdg.grid_shape and dg.ndofs == jdg.ndofs
    assert dg.ncells == jdg.ncells
    for d in range(3):
        np.testing.assert_array_equal(dg.axis_coords(d), jdg.axis_coords(d))
    np.testing.assert_array_equal(dg.dof_coords_grid(), jdg.dof_coords_grid())
    np.testing.assert_array_equal(dg.dofmap(), jdg.dofmap())
    assert dg.dofmap().dtype == jdg.dofmap().dtype


def _hide_h5py(monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py now raises


@pytest.mark.parametrize("writer", ["rectilinear", "unstructured", "series", "mesh"])
def test_hdf_without_h5py_raises_and_writes_nothing(tmp_path, monkeypatch, writer):
    axes, shape = _rect_axes()
    dofs, _ = _dof_pair(2)
    hm, _, _ = _mesh_and_tags()
    call = {
        "rectilinear": lambda p: io.write_xdmf_rectilinear(p, axes, _grid_fields(shape, 0),
                                                           data_format="hdf"),
        "unstructured": lambda p: io.write_xdmf_unstructured(
            p, dofs, _grid_fields((dofs.ndofs,), 0), data_format="hdf"),
        "series": lambda p: io.write_xdmf_time_series(p, axes, [(0.0, _grid_fields(shape, 0))],
                                                      data_format="hdf"),
        "mesh": lambda p: io.write_xdmf_mesh(p, hm, data_format="hdf"),
    }[writer]
    _hide_h5py(monkeypatch)
    with pytest.raises(ImportError, match=r"h5py.*data_format=\"binary\""):
        call(str(tmp_path / "out.xdmf"))
    assert list(tmp_path.iterdir()) == []


def test_hdf_reader_without_h5py_raises(tmp_path, monkeypatch):
    _write_pair(tmp_path, "h5")
    _hide_h5py(monkeypatch)
    with pytest.raises(ImportError, match="h5py"):
        io.read_xdmf(str(tmp_path / "mesh.xdmf"))


def test_unknown_data_format_raises(tmp_path):
    hm, _, _ = _mesh_and_tags()
    with pytest.raises(ValueError, match="data_format"):
        io.write_xdmf_mesh(str(tmp_path / "m.xdmf"), hm, data_format="netcdf")


def test_exterior_facets_check():
    """Exterior faces pass; an interior face and a quad that is no cell's
    face raise."""
    hm, facets, _ = _mesh_and_tags()
    check_exterior_facets(hm, facets)
    interior = hm.cells[0, [1, 3, 5, 7]]  # x-high face of cell 0, shared
    with pytest.raises(ValueError, match="1 of .* not exterior"):
        check_exterior_facets(hm, np.vstack([facets, interior]))
    with pytest.raises(ValueError, match="not exterior"):
        check_exterior_facets(hm, np.array([[0, 1, 2, 10_000]]))
