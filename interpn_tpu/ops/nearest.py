"""Nearest-neighbor interpolation, batched over queries.

Batched re-design of `src/nearest/regular.rs:234-316` and
`src/nearest/rectilinear.rs:193-265`: per-dimension independent selection with
the reference's documented tie-break — the midpoint (dt == 0.5) selects the
LOWER index (`nearest/regular.rs:283-287`). One gather per query batch.
"""

from __future__ import annotations

import jax.numpy as jnp

from ._gather import take1

from ..utils import c_strides
from .locate import locate_regular_linear, locate_rectilinear_linear

_I32 = jnp.int32


def nearest_regular(dims: tuple[int, ...], starts, steps, vals, obs):
    """Nearest-neighbor eval on a regular grid (1..6 dims, matching the
    reference ceiling at `src/nearest/regular.rs:97`)."""
    ndims = len(dims)
    strides = c_strides(dims)
    flat = jnp.zeros(obs[0].shape, dtype=_I32)
    for k in range(ndims):
        loc, dt = locate_regular_linear(obs[k], starts[k], steps[k], dims[k])
        offset = jnp.where(dt <= 0.5, 0, 1).astype(_I32)
        flat = flat + (loc + offset) * strides[k]
    return take1(vals, flat)


def nearest_rectilinear(grids, vals, obs):
    """Nearest-neighbor eval on a rectilinear grid (1..6 dims)."""
    ndims = len(grids)
    dims = tuple(int(g.shape[0]) for g in grids)
    strides = c_strides(dims)
    flat = jnp.zeros(obs[0].shape, dtype=_I32)
    for k in range(ndims):
        loc, x0, x1 = locate_rectilinear_linear(obs[k], grids[k])
        dt = (obs[k] - x0) / (x1 - x0)
        offset = jnp.where(dt <= 0.5, 0, 1).astype(_I32)
        flat = flat + (loc + offset) * strides[k]
    return take1(vals, flat)
