"""Heterogeneous media on the structured box: the port's
``LinearWave(c0_cells=...)`` against the JAX package's on its two-layer
case (tests/test_model.py:230-260) on the CPU in float64, with the energy
conservation; and the raises of the padded and sharded models, which build
their tables from c0 alone (the JAX package's silently ignore c0_cells)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_cases import max_rel

from wave_fenics_tpu.core.dofmap import StructuredDofGrid as JStructuredDofGrid
from wave_fenics_tpu.core.mesh import FacetTags as JFacetTags
from wave_fenics_tpu.core.mesh import box_mesh as jbox_mesh
from wave_fenics_tpu.models.linear_wave import LinearWave as JLinearWave
from wave_fenics_tpu_torch.core.mesh import FacetTags, box_mesh
from wave_fenics_tpu_torch.models.diagnostics import energy
from wave_fenics_tpu_torch.models.linear_wave import LinearWave
from wave_fenics_tpu_torch.models.linear_wave_padded import PaddedLinearWave
from wave_fenics_tpu_torch.parallel.sharded_padded import ShardedPaddedWave
from wave_fenics_tpu_torch.parallel.sharded_wave import ShardedLinearWave

F64 = torch.float64
TOL = 1e-12
CELLS, EXTENT = (4, 2, 2), (1.0, 0.5, 0.5)


def _two_layer(tags=None):
    jmesh = jbox_mesh(CELLS, EXTENT, facet_tags=JFacetTags(tags or {}))
    mesh = box_mesh(CELLS, EXTENT, facet_tags=FacetTags(tags or {}))
    c0_cells = np.where(mesh.cell_midpoints()[:, 0] < 0.5, 1.0, 1.3)
    return jmesh, mesh, c0_cells


def test_two_layer_matches_jax_and_conserves_energy():
    jmesh, mesh, c0_cells = _two_layer()
    jhet = JLinearWave(jmesh, p=3, c0=1.0, dtype=jnp.float64, c0_cells=c0_cells)
    het = LinearWave(mesh, p=3, c0=1.0, dtype=F64, device="cpu", c0_cells=c0_cells)
    hom = LinearWave(mesh, p=3, c0=1.0, dtype=F64, device="cpu")
    C = JStructuredDofGrid(jmesh, 3).dof_coords_grid()
    u0 = np.exp(-30 * (C[..., 0] - 0.3) ** 2)
    v0 = np.zeros_like(u0)
    dt, n = 1e-3, 300
    ju, jv, _ = jhet.solve(0.0, n * dt, dt, jnp.asarray(u0), jnp.asarray(v0))
    tu0, tv0 = torch.as_tensor(u0), torch.as_tensor(v0)
    u, v, _ = het.solve(0.0, n * dt, dt, tu0, tv0)
    assert max_rel(u, np.asarray(ju)) <= TOL and max_rel(v, np.asarray(jv)) <= TOL
    u_hom, _, _ = hom.solve(0.0, n * dt, dt, tu0, tv0)
    assert float(torch.linalg.norm(u - u_hom)) > 1e-3 * float(torch.linalg.norm(u_hom))
    # energy with the same heterogeneous operator is conserved (c0 = 1)
    e0, e1 = float(energy(het, tu0, tv0)), float(energy(het, u, v))
    np.testing.assert_allclose(e1, e0, rtol=1e-6)


def test_per_cell_stiffness_matches_jax():
    jmesh, mesh, c0_cells = _two_layer({1: (0,), 2: (1,)})
    jm = JLinearWave(jmesh, p=3, c0=1500.0, dtype=jnp.float64, c0_cells=1500.0 * c0_cells)
    tm = LinearWave(mesh, p=3, c0=1500.0, dtype=F64, device="cpu",
                    c0_cells=1500.0 * c0_cells)
    x = np.random.default_rng(8).standard_normal(tm.ops.grid_shape)
    assert max_rel(tm.ops.stiffness(torch.as_tensor(x), 1500.0),
                   np.asarray(jm.ops.stiffness(jnp.asarray(x), 1500.0))) <= TOL
    assert max_rel(tm.f1(2e-7, torch.as_tensor(x), torch.as_tensor(x)),
                   np.asarray(jm.f1(2e-7, jnp.asarray(x), jnp.asarray(x)))) <= TOL


@pytest.mark.parametrize("build", [
    lambda m: PaddedLinearWave(m, tile_x=16),
    lambda m: ShardedPaddedWave(m, (2, 1, 1), tile_x=16),
    lambda m: ShardedLinearWave(m, (2, 1, 1)),
], ids=["PaddedLinearWave", "ShardedPaddedWave", "ShardedLinearWave"])
def test_padded_and_sharded_models_raise_on_c0_cells(build):
    _, mesh, c0_cells = _two_layer({1: (0,), 2: (1,)})
    het = LinearWave(mesh, p=3, c0=1.0, dtype=F64, device="cpu", c0_cells=c0_cells)
    with pytest.raises(ValueError, match="c0_cells"):
        build(het)
    build(LinearWave(mesh, p=3, c0=1.0, dtype=F64, device="cpu"))  # homogeneous runs
