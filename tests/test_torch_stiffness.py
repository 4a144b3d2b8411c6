"""Kernel B (y = -c0^2 (K x)/m on the padded flat layout): the port's plain
version, and its plain twin in the CUDA kernel's sum order
(apply_stencil_plain), against the JAX TPU kernel in interpret mode; kernel
F's plain version (the separable stiffness on the unpadded grid, in the
CUDA kernel's own sum order) against the JAX package's at every degree.
The CUDA kernels are checked against the plain versions in
test_torch_gpu.py."""

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
from wave_fenics_tpu_torch.ops import stiffness, wave

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


@pytest.mark.parametrize("p", range(1, 9))
def test_flat_stencil_twin_matches_jax_kernel(p):
    """Kernel B's sum order (the x taps in k order, then the merged shift-0
    y/z tap, the y taps, the z taps; csrc/stencil_tiled.cuh) departs from
    the TPU kernel's band matrix and rolls: its plain twin
    (apply_stencil_plain) against the JAX flat kernel at every degree
    kernel B takes."""
    jpm, pm = padded_pair(shape=(3, 2, 2), p=p, tile_x=16)
    jlay, jb = jpm.layout, jpm.base
    A, _ = j_sep_tables(p, jb.mesh.h, jb.dtype)
    lines = j_grid_lines(jb.mesh.shape, p, jb.dtype)
    jtabs = jwave.build_tables_flat(
        jlay, A, lines, -float(jb.c0) ** 2, jpm._m_lines, dtype=jnp.float64
    )
    x = random_padded(jlay, 40 + p)
    ref = np.asarray(jax.jit(jwave.make_apply_flat(jlay, dtype=jnp.float64))(
        jnp.asarray(x), *[jnp.asarray(t) for t in jtabs]))
    got = wave.apply_stencil_plain(torch.as_tensor(x), pm.layout, pm.stencil)
    assert max_rel(got, ref) <= TOL


@pytest.mark.parametrize("p", range(1, 11))
def test_stiffness_grid_plain_matches_jax_every_degree(p):
    """Kernel F's plain version (its sums in the kernel's order) against the
    JAX package's separable stiffness at every degree kernel F takes, on a
    grid whose Nx, Ny, Nz all differ."""
    jm, tm = jax_model(shape=(3, 2, 1), p=p), torch_model(shape=(3, 2, 1), p=p)
    x = np.random.default_rng(50 + p).standard_normal(jm.ops.grid_shape)
    ref = np.asarray(jm.ops.stiffness(jnp.asarray(x), jm.c0))
    tabs = stiffness.GridStiffnessTables(*tables_from_numpy(
        stiffness.stiffness_grid_tables(tm.ops._sepA, tm.ops._seplines,
                                        tm.ops.grid_shape, p, -float(tm.c0) ** 2, F64),
        "cpu", F64))
    got = stiffness.stiffness_grid_plain(torch.as_tensor(x), tabs, p)
    assert max_rel(got, ref) <= TOL


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
    """Dispatch by device: a tensor neither on the CPU nor on a card never
    runs the plain version (a CUDA one runs kernel B or F)."""
    _, pm = padded_pair(p=2)
    meta = torch.empty(pm.layout.padded_shape, dtype=F64, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        pm._apply(meta)
    grid = torch.empty(pm.base.ops.grid_shape, dtype=F64, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        pm.base.ops.stiffness(grid, 1500.0)


@pytest.mark.parametrize("p,shape", [(3, (3, 2, 2)), (4, (2, 2, 2))])
def test_linear_wave_solve_on_cpu_matches_jax(p, shape):
    """The unpadded model on the CPU after the stiffness dispatch change:
    f1 still takes the plain separable stiffness and agrees with JAX."""
    jm, tm = jax_model(shape=shape, p=p), torch_model(shape=shape, p=p)
    dt = 1e-9
    ju, jv, jn = jm.solve(0.0, 20 * dt, dt)
    u, v, n = tm.solve(0.0, 20 * dt, dt)
    assert n == jn == 20
    assert max_rel(u, np.asarray(ju)) <= TOL
    assert max_rel(v, np.asarray(jv)) <= TOL
