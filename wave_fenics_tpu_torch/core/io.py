"""Mesh and field I/O in XDMF (host-side NumPy).

Port of ``wave_fenics_tpu.core.io``. It replaces the reference's mesh
ingest (``io::XDMFFile.read_mesh`` / ``read_meshtags``,
demo/cpu_planar3d/main.cpp:40-45), so a mesh exported for the reference
loads directly, and it writes solution fields for ParaView:

- ``read_xdmf``: a hexahedral grid, VTK/XDMF vertex order converted to
  basix order, as a ``HexMesh``; ``read_xdmf_meshtags``: quadrilateral facet
  tags (vertex ids as wound in the file, and the values);
  ``read_xdmf_attributes`` / ``read_xdmf_geometry``: the fields and the
  geometry arrays of a grid as stored;
- ``write_xdmf_rectilinear`` / ``write_xdmf_time_series``: dof-grid fields
  of a structured solve on a 3DRectMesh; ``write_xdmf_unstructured``: flat
  dof vectors of a general solve on its p^3 linear sub-hexes per cell;
- ``write_xdmf_mesh`` / ``write_xdmf_meshtags``: a ``HexMesh`` and its
  tagged facets in the form the readers (and the JAX package's readers, for
  ``data_format="xml"``) read;
- ``save_npz`` / ``load_npz``: the native lightweight format.

Heavy data. Every writer takes ``data_format``:

- ``"binary"`` (default): each dataset a raw little-endian file beside the
  ``.xdmf`` (``<stem>.<dataset>.bin``), referenced by a ``<DataItem
  Format="Binary" Endian="Little" NumberType=... Precision=...>``, which
  XDMF 3 readers such as ParaView read; needs nothing beyond NumPy;
- ``"hdf"``: the JAX package's layout in one ``<stem>.h5`` (``/x``, ``/y``,
  ``/z``, ``/geom``, ``/topo``, ``/<name>``, ``/step%06d/<name>``) and the
  same XDMF text; needs h5py, and raises an ImportError without it (never
  another format in its place);
- ``"xml"``: inline text (exact: the shortest repr of each number), for
  small meshes.

The readers take XML, Binary and HDF items; HDF needs h5py and raises the
same way without it. Fields keep the JAX package's dtypes in the files:
float64 coordinates and fields, int64 topology, int32 tag values.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from .mesh import HexMesh

__all__ = [
    "DATA_FORMATS",
    "read_xdmf",
    "read_xdmf_meshtags",
    "read_xdmf_attributes",
    "read_xdmf_geometry",
    "write_xdmf_mesh",
    "write_xdmf_meshtags",
    "write_xdmf_rectilinear",
    "write_xdmf_unstructured",
    "write_xdmf_time_series",
    "save_npz",
    "load_npz",
]

#: the heavy-data formats of the writers
DATA_FORMATS = ("binary", "hdf", "xml")

# XDMF/VTK hexahedron vertex order -> basix order (see core.basis); the
# permutation is its own inverse
_VTK_TO_BASIX = np.array([0, 1, 3, 2, 4, 5, 7, 6])
# XDMF/VTK quads are perimeter-wound (v0, v1, v2, v3); basix order is
# (v0, v1, v3, v2): the same swap both ways
QUAD_VTK_TO_BASIX = np.array([0, 1, 3, 2])

# (NumberType, Precision) of an XDMF data item -> NumPy kind and size
_KINDS = {"Float": "f", "Int": "i", "UInt": "u", "Char": "i", "UChar": "u"}
_NUMBER_TYPES = {"f": "Float", "i": "Int", "u": "UInt"}


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "HDF5 heavy data (Format=\"HDF\", data_format=\"hdf\") needs h5py, "
            "which is not installed; write with data_format=\"binary\" (the "
            "default) instead") from e
    return h5py


def _item_dtype(item: ET.Element) -> np.dtype:
    """The NumPy dtype of a Binary data item (XDMF defaults: Float, 4 bytes,
    native byte order)."""
    number_type = item.get("NumberType", item.get("DataType", "Float"))
    if number_type not in _KINDS:
        raise ValueError(f"unsupported XDMF NumberType {number_type!r}")
    size = int(item.get("Precision", 1 if number_type in ("Char", "UChar") else 4))
    order = {"Little": "<", "Big": ">", "Native": "="}[item.get("Endian", "Native")]
    return np.dtype(f"{order}{_KINDS[number_type]}{size}")


def _read_data_item(item: ET.Element, xdmf_dir: str) -> np.ndarray:
    fmt = item.get("Format", "XML")
    dims = [int(d) for d in item.get("Dimensions", "").split()]
    if fmt == "HDF":
        h5py = _h5py()
        fname, dset = item.text.strip().split(":")
        with h5py.File(os.path.join(xdmf_dir, fname), "r") as f:
            data = np.asarray(f[dset])
    elif fmt == "Binary":
        count = int(np.prod(dims)) if dims else -1
        data = np.fromfile(os.path.join(xdmf_dir, item.text.strip()),
                           dtype=_item_dtype(item), count=count,
                           offset=int(item.get("Seek", 0)))
        if dims and data.size != count:
            raise ValueError(f"{item.text.strip()}: {data.size} values, the item's "
                             f"Dimensions {dims} need {count}")
    elif fmt == "XML":
        data = np.fromstring(item.text.replace("\n", " "), sep=" ")
    else:
        raise ValueError(f"unsupported XDMF data format {fmt!r}")
    return data.reshape(dims) if dims else data


def _find_grid(root: ET.Element, name: str | None) -> ET.Element:
    grids = root.findall(".//Grid")
    if not grids:
        raise ValueError("no <Grid> in XDMF file")
    if name is None:
        return grids[0]
    for g in grids:
        if g.get("Name") == name:
            return g
    raise ValueError(f"grid {name!r} not found; have {[g.get('Name') for g in grids]}")


def _grid(path: str, grid_name: str | None) -> tuple[ET.Element, str]:
    root = ET.parse(path).getroot()
    return _find_grid(root, grid_name), os.path.dirname(os.path.abspath(path))


def read_xdmf(path: str, grid_name: str | None = None) -> HexMesh:
    """Read a hexahedral mesh from an XDMF file (DOLFINx/meshio flavour)."""
    grid, xdmf_dir = _grid(path, grid_name)
    topo = grid.find("Topology")
    geom = grid.find("Geometry")
    if topo is None or geom is None:
        raise ValueError("grid missing Topology/Geometry")
    ttype = (topo.get("TopologyType") or topo.get("Type") or "").lower()
    if "hexahedron" not in ttype:
        raise ValueError(f"only hexahedron meshes supported, got {ttype!r}")

    cells = _read_data_item(topo.find("DataItem"), xdmf_dir).astype(np.int64)
    cells = cells.reshape(-1, 8)[:, _VTK_TO_BASIX]
    points = _read_data_item(geom.find("DataItem"), xdmf_dir).astype(np.float64)
    if points.shape[1] == 2:
        points = np.concatenate([points, np.zeros((len(points), 1))], axis=1)
    return HexMesh(points=points, cells=cells)


def read_xdmf_meshtags(
    path: str, grid_name: str | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """(facets[n, 4] vertex ids as wound in the file, values[n]) of a
    quadrilateral facet-tag grid (the read_meshtags analogue for exterior
    boundary facets)."""
    grid, xdmf_dir = _grid(path, grid_name)
    topo = grid.find("Topology")
    facets = _read_data_item(topo.find("DataItem"), xdmf_dir).astype(np.int64)
    facets = facets.reshape(-1, 4)
    attr = grid.find("Attribute")
    if attr is None:
        raise ValueError("no Attribute (tag values) in meshtags grid")
    vals = _read_data_item(attr.find("DataItem"), xdmf_dir).astype(np.int32)
    return facets, vals.ravel()


def read_xdmf_attributes(path: str, grid_name: str | None = None) -> dict[str, np.ndarray]:
    """The Attribute arrays of a grid, by name, as stored (the writers'
    fields read back)."""
    grid, xdmf_dir = _grid(path, grid_name)
    return {a.get("Name"): _read_data_item(a.find("DataItem"), xdmf_dir)
            for a in grid.findall("Attribute")}


def read_xdmf_geometry(path: str, grid_name: str | None = None) -> list[np.ndarray]:
    """The Geometry arrays of a grid as stored, in file order (XYZ: one
    [n, 3] array; VXVYVZ: the z, y and x node lines)."""
    grid, xdmf_dir = _grid(path, grid_name)
    return [_read_data_item(i, xdmf_dir) for i in grid.find("Geometry").findall("DataItem")]


class _HeavyData:
    """The datasets of one XDMF file, written in one format; ``item`` writes
    a dataset and returns its ``<DataItem>``."""

    def __init__(self, path: str, data_format: str):
        if data_format not in DATA_FORMATS:
            raise ValueError(f"data_format {data_format!r}: one of {DATA_FORMATS}")
        self.base = os.path.splitext(os.path.abspath(path))[0]
        self.format = data_format
        h5py = _h5py() if data_format == "hdf" else None
        os.makedirs(os.path.dirname(self.base), exist_ok=True)
        self._h5 = h5py.File(self.base + ".h5", "w") if h5py is not None else None

    @property
    def xdmf_path(self) -> str:
        return self.base + ".xdmf"

    def item(self, name: str, arr: np.ndarray) -> str:
        dims = " ".join(str(d) for d in arr.shape)
        if self.format == "hdf":
            self._h5["/" + name] = arr
            return (f'<DataItem Dimensions="{dims}" Format="HDF">'
                    f'{os.path.basename(self.base)}.h5:/{name}</DataItem>')
        kind = f'NumberType="{_NUMBER_TYPES[arr.dtype.kind]}" Precision="{arr.itemsize}"'
        if self.format == "xml":
            rows = arr.reshape(arr.shape[0], -1) if arr.ndim > 1 else arr[None, :]
            text = "\n".join(" ".join(map(str, row)) for row in rows.tolist())
            return f'<DataItem Dimensions="{dims}" Format="XML" {kind}>\n{text}\n</DataItem>'
        fname = f"{os.path.basename(self.base)}.{name.replace('/', '_')}.bin"
        np.ascontiguousarray(arr, dtype=arr.dtype.newbyteorder("<")).tofile(
            os.path.join(os.path.dirname(self.base), fname))
        return (f'<DataItem Dimensions="{dims}" Format="Binary" {kind} '
                f'Endian="Little">{fname}</DataItem>')

    def write_xdmf(self, body: str) -> None:
        if self._h5 is not None:
            self._h5.close()
            self._h5 = None
        with open(self.xdmf_path, "w") as f:
            f.write(f"""<?xml version="1.0"?>
<Xdmf Version="3.0"><Domain>
{body}
</Domain></Xdmf>""")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._h5 is not None:
            self._h5.close()


def _f64(name: str, arr, shape: tuple) -> np.ndarray:
    arr = np.asarray(arr, dtype=np.float64)
    if arr.shape != shape:
        raise ValueError(f"field {name!r} has shape {arr.shape}, the grid {shape}")
    return arr


def _attributes(hd: _HeavyData, fields: dict, shape: tuple, prefix: str = "") -> str:
    return "\n".join(
        f"""<Attribute Name="{n}" Center="Node">
{hd.item(prefix + n, _f64(n, a, shape))}
</Attribute>"""
        for n, a in fields.items())


def _rect_geometry(hd: _HeavyData, axis_coords) -> tuple[str, tuple]:
    # XDMF VXVYVZ order is (z, y, x)-fastest; our arrays are x-major
    x, y, z = [np.asarray(c, dtype=np.float64) for c in axis_coords]
    items = {n: hd.item(n, a) for n, a in (("x", x), ("y", y), ("z", z))}
    return (f"""<Geometry GeometryType="VXVYVZ">
{items["z"]}
{items["y"]}
{items["x"]}
</Geometry>""", (x.size, y.size, z.size))


def write_xdmf_rectilinear(
    path: str,
    axis_coords: tuple[np.ndarray, np.ndarray, np.ndarray],
    fields: dict[str, np.ndarray],
    time: float | None = None,
    data_format: str = "binary",
) -> None:
    """Write dof-grid fields as an XDMF 3DRectMesh (ParaView-readable):
    ``axis_coords`` are the GLL node lines (``StructuredDofGrid.
    axis_coords``), ``fields`` maps name -> [Nx, Ny, Nz] array. The
    reference never writes solution fields (SURVEY.md §5)."""
    with _HeavyData(path, data_format) as hd:
        geom, shape = _rect_geometry(hd, axis_coords)
        attrs = _attributes(hd, fields, shape)
        dims = f"{shape[0]} {shape[1]} {shape[2]}"
        tval = f'<Time Value="{time}"/>' if time is not None else ""
        hd.write_xdmf(f"""<Grid Name="grid">{tval}
<Topology TopologyType="3DRectMesh" Dimensions="{dims}"/>
{geom}
{attrs}
</Grid>""")


def sub_hex_topology(dofmap: np.ndarray, p: int) -> np.ndarray:
    """[ncells * p^3, 8] int64: each degree-p cell's p^3 linear sub-hexes
    over its GLL nodes, VTK winding (bottom quad counter-clockwise, then
    the top)."""
    m = p + 1
    idx = np.arange(m**3).reshape(m, m, m)  # (x, y, z)-nodes, z fastest
    corners = [
        idx[di : di + p, dj : dj + p, dk : dk + p].reshape(-1)
        for di, dj, dk in ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
                           (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))
    ]
    sub = np.stack(corners, axis=1)  # [p^3, 8] local node ids
    return np.asarray(dofmap, np.int64)[:, sub].reshape(-1, 8)


def write_xdmf_unstructured(
    path: str,
    dofs,
    fields: dict[str, np.ndarray],
    time: float | None = None,
    data_format: str = "binary",
) -> None:
    """Write flat dof-vector fields of a general (imported) solve as an
    XDMF hexahedral grid (ParaView-readable): each degree-p cell as its p^3
    linear sub-hexes over the GLL nodes, so nodal values sit exactly at the
    dof points, and ``read_xdmf`` reads the file back as a mesh whose
    points are ``dofs.dof_coords``. ``dofs``: ``core.dofmap.GeneralDofMap``;
    ``fields``: name -> [ndofs]."""
    topo = sub_hex_topology(dofs.dofmap, dofs.p)
    with _HeavyData(path, data_format) as hd:
        geom = hd.item("geom", np.asarray(dofs.dof_coords, np.float64))
        tp = hd.item("topo", topo)
        flat = {n: np.asarray(a, np.float64).reshape(-1) for n, a in fields.items()}
        attrs = _attributes(hd, flat, (dofs.ndofs,))
        tval = f'<Time Value="{time}"/>' if time is not None else ""
        hd.write_xdmf(f"""<Grid Name="grid">{tval}
<Topology TopologyType="Hexahedron" NumberOfElements="{topo.shape[0]}">
{tp}
</Topology>
<Geometry GeometryType="XYZ">
{geom}
</Geometry>
{attrs}
</Grid>""")


def write_xdmf_time_series(
    path: str,
    axis_coords: tuple[np.ndarray, np.ndarray, np.ndarray],
    snapshots: list[tuple[float, dict[str, np.ndarray]]],
    data_format: str = "binary",
) -> None:
    """Write a temporal collection of dof-grid fields (ParaView-readable).
    ``snapshots``: list of (time, {name: [Nx, Ny, Nz]}); one XDMF temporal
    grid references every dataset."""
    with _HeavyData(path, data_format) as hd:
        geom, shape = _rect_geometry(hd, axis_coords)
        dims = f"{shape[0]} {shape[1]} {shape[2]}"
        grids = []
        for s, (t, fields) in enumerate(snapshots):
            attrs = _attributes(hd, fields, shape, prefix=f"step{s:06d}/")
            grids.append(f"""<Grid Name="t{s}"><Time Value="{t}"/>
<Topology TopologyType="3DRectMesh" Dimensions="{dims}"/>
{geom}
{attrs}
</Grid>""")
        body = "\n".join(grids)
        hd.write_xdmf(f"""<Grid Name="series" GridType="Collection" CollectionType="Temporal">
{body}
</Grid>""")


def write_xdmf_mesh(path: str, mesh: HexMesh, data_format: str = "binary",
                    grid_name: str = "mesh") -> None:
    """Write a ``HexMesh`` as an XDMF hexahedron grid (cells in VTK vertex
    order, float64 points), the form ``read_xdmf`` reads back exactly."""
    cells = np.asarray(mesh.cells, np.int64)[:, _VTK_TO_BASIX]
    with _HeavyData(path, data_format) as hd:
        tp = hd.item("topo", cells)
        geom = hd.item("geom", np.asarray(mesh.points, np.float64))
        hd.write_xdmf(f"""<Grid Name="{grid_name}">
<Topology TopologyType="Hexahedron" NumberOfElements="{len(cells)}">
{tp}
</Topology>
<Geometry GeometryType="XYZ">
{geom}
</Geometry>
</Grid>""")


def write_xdmf_meshtags(path: str, mesh: HexMesh, facets: np.ndarray, values,
                        data_format: str = "binary", grid_name: str = "facet_tags") -> None:
    """Write tagged facets (``facets`` [n, 4] in basix quad order, ``values``
    [n] integer tags) as an XDMF quadrilateral grid over the mesh's points,
    each facet perimeter-wound as in a DOLFINx export; ``read_xdmf_meshtags``
    gives them back wound so."""
    quads = np.asarray(facets, np.int64)[:, QUAD_VTK_TO_BASIX]
    vals = np.asarray(values, np.int32).reshape(-1)
    if len(vals) != len(quads):
        raise ValueError(f"{len(quads)} facets but {len(vals)} tag values")
    with _HeavyData(path, data_format) as hd:
        tp = hd.item("ftopo", quads)
        geom = hd.item("geom", np.asarray(mesh.points, np.float64))
        tv = hd.item("fvals", vals)
        hd.write_xdmf(f"""<Grid Name="{grid_name}">
<Topology TopologyType="Quadrilateral" NumberOfElements="{len(quads)}">
{tp}
</Topology>
<Geometry GeometryType="XYZ">
{geom}
</Geometry>
<Attribute Name="tags" Center="Cell">
{tv}
</Attribute>
</Grid>""")


def save_npz(path: str, mesh: HexMesh) -> None:
    np.savez(
        path,
        points=mesh.points,
        cells=mesh.cells,
        facets=mesh.facets if mesh.facets is not None else np.zeros((0, 4), np.int64),
        facet_tag_values=(
            mesh.facet_tag_values
            if mesh.facet_tag_values is not None
            else np.zeros((0,), np.int32)
        ),
    )


def load_npz(path: str) -> HexMesh:
    d = np.load(path)
    facets = d["facets"] if d["facets"].size else None
    vals = d["facet_tag_values"] if d["facet_tag_values"].size else None
    return HexMesh(points=d["points"], cells=d["cells"], facets=facets,
                   facet_tag_values=vals)
