"""Kernel B (y = -c0^2 (K x)/m on the padded flat layout): the port's plain
version against the JAX TPU kernel in interpret mode, the separable
stiffness against the JAX package's. The CUDA kernel is checked against
the plain version in test_torch_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import (
    jax_model,
    max_rel,
    padded_pair,
    random_padded,
    torch_model,
)
from wave_fenics_tpu.ops import pallas_wave as jwave
from wave_fenics_tpu.ops.separable import grid_lines as j_grid_lines
from wave_fenics_tpu.ops.separable import (
    separable_stiffness_tables as j_sep_tables,
)
from wave_fenics_tpu_torch.convert import tables_from_numpy
from wave_fenics_tpu_torch.ops import wave

F64 = torch.float64
TOL = 1e-12  # f64, relative to max |ref|: only association order differs


@pytest.mark.parametrize("p,tile_x", [(2, 16), (4, 16), (3, 24)])
def test_apply_flat_plain_matches_jax_kernel(p, tile_x):
    jpm, pm = padded_pair(shape=(4, 2, 3), p=p, tile_x=tile_x)
    jlay = jpm.layout
    jb = jpm.base
    A, _ = j_sep_tables(p, jb.mesh.h, jb.dtype)
    lines = j_grid_lines(jb.mesh.shape, p, jb.dtype)
    jtabs = jwave.build_tables_flat(
        jlay, A, lines, -float(jb.c0) ** 2, jpm._m_lines, dtype=jnp.float64
    )
    x = random_padded(jlay, 11)
    ref = np.asarray(jax.jit(jwave.make_apply_flat(jlay, dtype=jnp.float64))(
        jnp.asarray(x), *[jnp.asarray(t) for t in jtabs]))
    xt = torch.as_tensor(x)
    # JAX's own tables carried across, and the port's own table functions
    y_conv = wave.apply_flat_plain(
        xt, pm.layout, wave.FlatTables(*tables_from_numpy(jtabs, "cpu", F64)))
    y_own = pm._apply(xt)
    assert max_rel(y_conv, ref) <= TOL
    assert max_rel(y_own, ref) <= TOL
    np.testing.assert_array_equal(y_conv.numpy(), y_own.numpy())


@pytest.mark.parametrize("p", [2, 4])
def test_separable_stiffness_matches_jax(p):
    jm, tm = jax_model(p=p), torch_model(p=p)
    x = np.random.default_rng(12).standard_normal(jm.ops.grid_shape)
    ref = np.asarray(jm.ops.stiffness(jnp.asarray(x), jm.c0) * jm.inv_m)
    got = tm.ops.stiffness(torch.as_tensor(x), tm.c0) * tm.inv_m
    assert max_rel(got, ref) <= TOL


@pytest.mark.parametrize("p", [2, 4])
def test_padded_apply_matches_unpadded_and_keeps_zero_padding(p):
    _, pm = padded_pair(p=p)
    base = pm.base
    x = torch.as_tensor(np.random.default_rng(13).standard_normal(base.ops.grid_shape))
    kv = pm._apply(pm.from_grid(x))
    ref = base.ops.stiffness(x, base.c0) * base.inv_m
    assert max_rel(pm.to_grid(kv), ref) <= TOL
    outside = kv.clone()
    outside[pm.layout.interior] = 0.0
    assert float(outside.abs().max()) == 0.0


def test_non_cpu_tensors_do_not_take_the_plain_path():
    """Dispatch by device: a non-CPU tensor never runs the plain version."""
    _, pm = padded_pair(p=2)
    meta = torch.empty(pm.layout.padded_shape, dtype=F64, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        pm._apply(meta)
    grid = torch.empty(pm.base.ops.grid_shape, dtype=F64, device="meta")
    with pytest.raises(NotImplementedError, match="kernel F"):
        pm.base.ops.stiffness(grid, 1500.0)
