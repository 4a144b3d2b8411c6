"""The hand-written CUDA kernels against their plain versions (float64).

Every test here needs a CUDA card and skips without one. The file imports
only torch and the port, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from wave_fenics_tpu_torch.core.mesh import FacetTags, box_mesh
from wave_fenics_tpu_torch.models.linear_wave import LinearWave
from wave_fenics_tpu_torch.models.linear_wave_padded import PaddedLinearWave
from wave_fenics_tpu_torch.ops import rk4step, wave

pytestmark = pytest.mark.gpu

F64 = torch.float64
DT = 1e-9
GS = (1.0, 0.7, 0.4, 0.1)  # distinct per-stage sources
TOL = 1e-12  # f64; only association order differs between kernel and plain


@pytest.fixture
def cuda():
    """The CUDA device, with TF32 off for the plain versions; skips the test
    where no card is present (decided at run time, not at collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _model(p, device, shape=(4, 2, 2)):
    mesh = box_mesh(shape, (0.01, 0.005, 0.005),
                    facet_tags=FacetTags({1: (0,), 2: (1,)}))
    return PaddedLinearWave(
        LinearWave(mesh, p=p, dtype=F64, device=device), tile_x=16)


def _random_padded(layout, seed, device, scale=1.0):
    x = np.zeros(layout.padded_shape)
    x[layout.interior] = scale * np.random.default_rng(seed).standard_normal(layout.shape)
    return torch.as_tensor(x, device=device)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("p", [2, 4])
def test_apply_flat_cuda_matches_plain(cuda, p):
    pm = _model(p, cuda)
    x = _random_padded(pm.layout, 14, cuda)
    n0 = wave.apply_flat_cuda.launches
    y = pm._apply(x)
    torch.cuda.synchronize()
    assert wave.apply_flat_cuda.launches == n0 + 1
    ref = wave.apply_flat_plain(x, pm.layout, pm.flat_tables)
    assert _rel(y, ref) <= TOL
    outside = y.clone()
    outside[pm.layout.interior] = 0.0
    assert float(outside.abs().max()) == 0.0


def test_apply_flat_cuda_rejects_bad_operands(cuda):
    pm = _model(2, cuda)
    x = torch.zeros(pm.layout.padded_shape, dtype=F64, device=cuda)
    with pytest.raises(TypeError):
        wave.apply_flat_cuda(x.float(), pm.layout, pm.stencil)
    with pytest.raises(ValueError):
        wave.apply_flat_cuda(x, pm.layout, pm.stencil, out=x)
    with pytest.raises(ValueError):
        wave.apply_flat_cuda(x.transpose(1, 2), pm.layout, pm.stencil)


@pytest.mark.parametrize("p", [2, 4])
def test_cuda_step_matches_plain(cuda, p):
    pm = _model(p, cuda)
    u0 = _random_padded(pm.layout, 31, cuda)
    v0 = _random_padded(pm.layout, 32, cuda, scale=1e3)
    args = (DT, GS, pm.layout, pm.base.c0)
    n0 = rk4step.rk4_step_lean_cuda.launches
    uk, vk = rk4step.rk4_step_lean(u0, v0, *args, pm.step_tables, pm.stencil,
                                   pm.src_x, pm.abc_x)
    torch.cuda.synchronize()
    assert rk4step.rk4_step_lean_cuda.launches == n0 + rk4step.LAUNCHES_PER_STEP
    up, vp = rk4step.rk4_step_lean_plain(u0, v0, *args, pm.step_tables)
    vmax = float(vp.abs().max())
    assert float((uk - up).abs().max()) <= TOL * max(vmax, 1.0)
    assert float((vk - vp).abs().max()) <= TOL * vmax


@pytest.mark.parametrize("p", [2, 4])
def test_cuda_solve_step_n_matches_cpu(cuda, p):
    u_c, v_c, _ = _model(p, "cpu").solve_step_n(0.0, DT, 25)
    u_g, v_g, _ = _model(p, cuda).solve_step_n(0.0, DT, 25)
    vmax = float(v_c.abs().max())
    assert vmax > 0.0
    assert float((u_g.cpu() - u_c).abs().max()) <= TOL * max(vmax, 1.0)
    assert float((v_g.cpu() - v_c).abs().max()) <= TOL * vmax


def test_cuda_step_rejects_aliasing(cuda):
    pm = _model(2, cuda)
    u0 = _random_padded(pm.layout, 33, cuda)
    v0 = _random_padded(pm.layout, 34, cuda)
    with pytest.raises(ValueError, match="alias"):
        rk4step.rk4_step_lean_cuda(
            u0, v0, DT, GS, pm.layout, pm.base.c0, pm.stencil,
            pm.step_tables.W1, pm.step_tables.W2, pm.src_x, pm.abc_x,
            out=(u0, v0),
        )
