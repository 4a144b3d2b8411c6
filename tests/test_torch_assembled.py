"""The port's element-assembly operator (``ops.assembled.EAOperator``)
against the JAX package's on the same perturbed meshes (tests/
test_assembled.py), against the matrix-free operators and against the
assembled CSR matvec, on the CPU in float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_cases import max_rel

from wave_fenics_tpu.core.dofmap import build_dofmap as jbuild_dofmap
from wave_fenics_tpu.core.mesh import HexMesh as JHexMesh
from wave_fenics_tpu.core.mesh import box_mesh as jbox_mesh
from wave_fenics_tpu.ops import assembled as jassembled
from wave_fenics_tpu_torch.convert import general_mesh_from_numpy
from wave_fenics_tpu_torch.core.dofmap import build_dofmap
from wave_fenics_tpu_torch.ops import assembled
from wave_fenics_tpu_torch.ops.operators import GeneralOperators

F64 = torch.float64
TOL = 1e-12


def _meshes(seed=0):
    """JAX's perturbed (2,2,2)-cell box (tests/test_assembled.py:17-23) and
    the port's copy of it."""
    m = jbox_mesh((2, 2, 2), (1.0, 1.1, 0.9)).to_hex_mesh()
    rng = np.random.default_rng(seed)
    jm = JHexMesh(points=m.points + 0.03 * rng.standard_normal(m.points.shape),
                  cells=m.cells)
    return jm, general_mesh_from_numpy(jm.points, jm.cells)[0]


@pytest.mark.parametrize("kind", ["mass", "stiffness"])
@pytest.mark.parametrize("p", [2, 3])
def test_ea_matches_jax_and_matrix_free(kind, p):
    jm, m = _meshes()
    coeff = -1.0 if kind == "stiffness" else 1.0
    jdofs, dofs = jbuild_dofmap(jm, p), build_dofmap(m, p)
    A_e = assembled.assemble_element_tensors(m, p, kind=kind, coeff=coeff)
    jea = jassembled.EAOperator(jdofs, jassembled.assemble_element_tensors(
        jm, p, kind=kind, coeff=coeff), dtype=jnp.float64)
    ea = assembled.EAOperator(dofs, A_e, dtype=F64, device="cpu")
    assert ea.A_e.dtype == F64 and ea.A_e.device.type == "cpu"
    x = np.random.default_rng(1).standard_normal(dofs.ndofs)
    y = ea(torch.as_tensor(x))
    assert max_rel(y, np.asarray(jea(jnp.asarray(x)))) <= TOL
    # the matrix-free operator on the unclamped geometry (JAX's check, 1e-9)
    mf = GeneralOperators(m, dofs, dtype=F64)
    ref = mf.mass(torch.as_tensor(x)) if kind == "mass" else mf.stiffness(
        torch.as_tensor(x), 1.0)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("kind", ["mass", "stiffness"])
def test_ea_matches_csr(kind):
    jm, m = _meshes(2)
    dofs = build_dofmap(m, 2)
    A_e = assembled.assemble_element_tensors(m, 2, kind=kind)
    ea = assembled.EAOperator(dofs, A_e, dtype=F64, device="cpu")
    x = np.random.default_rng(3).standard_normal(dofs.ndofs)
    A = assembled.csr_tensor(assembled.assemble_csr(dofs, A_e), "cpu", F64)
    y_csr = torch.sparse.mm(A, torch.as_tensor(x)[:, None])[:, 0]
    assert max_rel(ea(torch.as_tensor(x)), y_csr) <= TOL


def test_ea_is_an_nn_module_of_the_operator_dtype():
    jm, m = _meshes()
    dofs = build_dofmap(m, 2)
    ea = assembled.EAOperator(dofs, assembled.assemble_element_tensors(m, 2),
                              dtype=torch.float32, device="cpu")
    assert isinstance(ea, torch.nn.Module)
    assert {n for n, _ in ea.named_buffers()} == {"A_e", "dofmap"}
    assert ea.A_e.dtype == torch.float32
    y = ea(torch.ones(dofs.ndofs, dtype=torch.float32))
    assert y.dtype == torch.float32 and y.shape == (dofs.ndofs,)
