"""Shared constructors for the port's tests: the same small models in both
packages.

The sizes are the (4, 2, 2)-cell models of ``test_padded_model.py``;
everything is float64, and inputs come from ``np.random.default_rng``.
"""

import jax.numpy as jnp
import numpy as np
import torch

from wave_fenics_tpu.core.mesh import FacetTags as JFacetTags
from wave_fenics_tpu.core.mesh import box_mesh as jbox_mesh
from wave_fenics_tpu.models.linear_wave import LinearWave as JLinearWave
from wave_fenics_tpu.models.linear_wave_padded import (
    PaddedLinearWave as JPaddedLinearWave,
)
from wave_fenics_tpu_torch.core.mesh import FacetTags, box_mesh
from wave_fenics_tpu_torch.models.linear_wave import LinearWave
from wave_fenics_tpu_torch.models.linear_wave_padded import PaddedLinearWave

# The suite runs in several worker processes at once. torch's intra-op
# thread pool, sized to all cores in each of them, oversubscribes the
# machine, and its spinning threads slow these small-tensor tests down by
# a factor of 50 or more; one thread per process runs them at full speed.
torch.set_num_threads(1)

EXTENT = (0.01, 0.005, 0.005)
X_FACES = {1: (0,), 2: (1,)}


def jax_model(shape=(4, 2, 2), p=4, tags=X_FACES):
    mesh = jbox_mesh(shape, EXTENT, facet_tags=JFacetTags(tags))
    return JLinearWave(mesh, p=p, dtype=jnp.float64)


def torch_model(shape=(4, 2, 2), p=4, tags=X_FACES, device="cpu"):
    mesh = box_mesh(shape, EXTENT, facet_tags=FacetTags(tags))
    return LinearWave(mesh, p=p, dtype=torch.float64, device=device)


def padded_pair(shape=(4, 2, 2), p=4, tile_x=16, device="cpu"):
    """(JAX PaddedLinearWave, port PaddedLinearWave) of the same model."""
    return (
        JPaddedLinearWave(jax_model(shape, p), tile_x=tile_x),
        PaddedLinearWave(torch_model(shape, p, device=device), tile_x=tile_x),
    )


def random_padded(layout, seed):
    """A random state on the interior of ``layout``, zero in the padding."""
    x = np.zeros(layout.padded_shape)
    x[layout.interior] = np.random.default_rng(seed).standard_normal(layout.shape)
    return x


def max_rel(a, b) -> float:
    """max |a - b| / max |b| (NumPy or tensors)."""
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
    b = np.asarray(b.cpu() if isinstance(b, torch.Tensor) else b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
