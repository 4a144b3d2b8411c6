"""The benchmark's mesh configuration (``port_bench``'s ``planar3d-mesh-p4``)
on the CPU in float64: the port's general RK4 path against the plain
reference ``reference/mesh_wave.py``; that reference's stiffness against
the box reference's on an unjittered box and against a dense assembled K;
the entry's map between the node lattice and the port's dofs; the
benchmark's mesh against ``general_solve.perturbed_box``; and both sides'
step count at full size."""

import itertools
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from port_bench import harness, inputs, meshes
from port_bench.entries import mesh_solve
from port_bench.reference import box_wave, gll, mesh_wave
from wave_fenics_tpu_torch.benchmarks.general_solve import perturbed_box
from wave_fenics_tpu_torch.core.mesh import HexMesh
from wave_fenics_tpu_torch.models import planar3d

F64 = torch.float64
CONFIG = json.loads((harness.ROOT / "configs" / "planar3d-mesh-p4.json").read_text())
TRAFFIC = json.loads((harness.ROOT / "traffic" / "rk4-mesh.json").read_text())


def _config(**keys):
    return {**CONFIG, "dtype": "f64", **keys}


@pytest.mark.parametrize("cells,p", [((4, 2, 2), 4), ((3, 2, 2), 2)])
def test_port_rk4_matches_the_reference(cells, p):
    """20 RK4 steps of ``GeneralLinearWave`` through the entry against the
    reference's, from a seeded state, within 1e-10 of max |ref|."""
    config = _config(cells=list(cells), degree=p)
    raw = inputs.make(config, {**TRAFFIC["inputs"], "dtype": "f64"}, 2 ** 31 + 21, "cpu")
    entry = mesh_solve.Entry(config, TRAFFIC, "cpu")
    entry.load(raw)
    ref = mesh_wave.Reference(config, TRAFFIC, "cpu")
    assert (entry.dt, entry.steps) == (ref.dt, ref.steps)
    entry.steps = ref.steps = 20
    out, steps = entry.solve(*entry.inputs[1])
    assert steps == 20
    got, want = entry.answer(out), ref.answer(raw[1])
    for k in ("u", "v"):
        assert float((got[k] - want[k]).abs().max()) <= 1e-10 * float(want[k].abs().max())
    assert max(mesh_wave.compare(got, want).values()) <= 1e-10


def test_reference_on_a_box_is_the_box_reference():
    """Unjittered, the mesh reference's -c0^2 K u / m, source and damping
    are the box reference's Kronecker products."""
    config = _config(cells=[4, 2, 2], jitter_rel=0.0)
    mesh, box = (mesh_wave.Reference(config, TRAFFIC, "cpu"),
                 box_wave.Reference(config, TRAFFIC, "cpu"))
    assert (mesh.dt, mesh.steps) == (box.dt, box.steps)
    u = torch.randn((17, 9, 9), dtype=F64, generator=torch.Generator().manual_seed(4))
    want = box._ku(u)
    got = mesh.stiffness(u) * mesh.neg_c2_inv_m
    assert float((got - want).abs().max()) <= 1e-13 * float(want.abs().max())
    c0 = config["c0"]
    assert torch.allclose(mesh.src, torch.full_like(mesh.src, c0 ** 2 * box.inv_lx0),
                          rtol=1e-13, atol=0)
    assert torch.allclose(mesh.damp, torch.full_like(mesh.damp, c0 * box.inv_lxn),
                          rtol=1e-13, atol=0)


def _dense_stiffness(config):
    """K of the configuration's mesh assembled densely, cell by cell and
    point by point in NumPy: at each GLL point the Jacobian of the
    trilinear map from the eight vertices, the physical gradients
    J^-T grad phi_i, and w |det J| grad phi_i . grad phi_j, with the
    geometry snapped as the demo snaps it."""
    cells, p = tuple(config["cells"]), config["degree"]
    m = p + 1
    pts = meshes.vertex_lattice(config).reshape(-1, 3)
    hexes, index = meshes.hex_cells(cells), meshes.node_lattice_index(cells, p)
    nodes, w = gll.gll(m)
    _, D = gll.lagrange(nodes, nodes)
    n = int(np.prod([c * p + 1 for c in cells]))
    K = np.zeros((n, n))
    local = list(itertools.product(range(m), repeat=3))
    for c, vertices in enumerate(hexes):
        Ke = np.zeros((m ** 3, m ** 3))
        for q in local:
            xi = [nodes[i] for i in q]
            J = np.zeros((3, 3))
            for v in range(8):
                bits = (v & 1, (v >> 1) & 1, (v >> 2) & 1)
                lv = [x if b else 1.0 - x for x, b in zip(xi, bits)]
                dv = [1.0 if b else -1.0 for b in bits]
                J += np.outer(pts[vertices[v]], [dv[0] * lv[1] * lv[2], lv[0] * dv[1] * lv[2],
                                                 lv[0] * lv[1] * dv[2]])
            ref_grad = np.array([[D[q[0], a] * (b == q[1]) * (e == q[2]),
                                  (a == q[0]) * D[q[1], b] * (e == q[2]),
                                  (a == q[0]) * (b == q[1]) * D[q[2], e]] for a, b, e in local])
            Jinv = np.linalg.inv(J)
            G = Jinv @ Jinv.T * abs(np.linalg.det(J)) * w[q[0]] * w[q[1]] * w[q[2]]
            G[np.isclose(G, 0.0, rtol=1e-5, atol=1e-8)] = 0.0
            Ke += ref_grad @ G @ ref_grad.T
        K[np.ix_(index[c], index[c])] += Ke
    return K


def test_reference_stiffness_is_the_dense_assembled_k():
    config = _config(cells=[2, 2, 2], degree=3, jitter_rel=0.15)
    K = _dense_stiffness(config)
    ref = mesh_wave.Reference(config, TRAFFIC, "cpu")
    u = np.random.default_rng(5).standard_normal(K.shape[0])
    got = ref.stiffness(torch.tensor(u.reshape(7, 7, 7))).numpy().reshape(-1)
    want = K @ u
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    assert np.abs(K - K.T).max() <= 1e-12 * np.abs(K).max()
    assert np.abs(K.sum(axis=1)).max() <= 1e-12 * np.abs(K).max()


def test_lattice_and_dofs_round_trip():
    """The entry's map is one to one: a lattice state carried into the
    port's dofs and back is unchanged, and each dof sits at its lattice
    node (the x = 0 and x = L planes of the lattice are the mesh's faces)."""
    config = _config(cells=[3, 2, 2], degree=4)
    entry = mesh_solve.Entry(config, TRAFFIC, "cpu")
    shape = (13, 9, 9)
    states = [{k: torch.randn(shape, dtype=F64) for k in ("u", "v")} for _ in range(2)]
    entry.load(states)
    for state, (u, v) in zip(states, entry.inputs):
        back = entry.answer(((u, v), None))
        assert torch.equal(back["u"], state["u"]) and torch.equal(back["v"], state["v"])
    x = torch.as_tensor(entry.model.dofs.dof_coords)[entry.dof].view(*shape, 3)
    assert float(x[0, ..., 0].abs().max()) <= 1e-15
    assert float((x[-1, ..., 0] - config["length"]).abs().max()) <= 1e-15
    assert torch.equal(entry.dof.sort().values, torch.arange(entry.model.ndofs))


@pytest.mark.parametrize("cells", [(4, 2, 2), (64, 32, 32)])
def test_benchmark_mesh_is_perturbed_box(cells):
    """``meshes.py`` makes ``perturbed_box``'s points, cells and facet tags,
    bit for bit, at a small size and at the configuration's."""
    config = {**CONFIG, "cells": list(cells)}
    hm, tags = perturbed_box(cells, h=config["length"] / cells[0],
                             amp_rel=config["jitter_rel"], seed=config["mesh_seed"])
    X = meshes.vertex_lattice(config)
    assert X.shape == (*(n + 1 for n in cells), 3)
    assert np.array_equal(X.reshape(-1, 3), hm.points)
    assert np.array_equal(meshes.hex_cells(cells), hm.cells)
    assert np.array_equal(meshes.x_facets(cells, 0), tags[1])
    assert np.array_equal(meshes.x_facets(cells, 1), tags[2])


def test_both_sides_take_1654_steps_at_full_size():
    """The configuration's solve is 1,654 steps at 40 a period on both
    sides: the reference's cell diameters from the lattice, the port's
    ``general_case`` on the mesh's own ``hmin`` (host only)."""
    X = meshes.vertex_lattice(CONFIG)
    dt, steps = mesh_wave.case_steps(CONFIG, X)
    mesh = HexMesh(points=X.reshape(-1, 3), cells=meshes.hex_cells(CONFIG["cells"]))
    model = SimpleNamespace(mesh=mesh, c0=CONFIG["c0"], p=CONFIG["degree"],
                            freq0=CONFIG["f0"])
    case = planar3d.general_case(model, CONFIG["cfl"], CONFIG["tail_periods"])
    assert mesh_wave.hmin(X) == mesh.hmin()
    assert (case.dt, case.nsteps, case.steps_per_period) == (dt, 1654, 40)
    assert steps == 1654
