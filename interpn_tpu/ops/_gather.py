"""Batched 1D gathers with in-bounds promise.

All stencil indices in interpn-tpu are in range by construction (cell
locations are clamped to the grid interior before offsets are added), so the
gathers skip XLA's bounds clamping — `jnp.take` in current JAX does not expose
PROMISE_IN_BOUNDS, but the `.at[].get` API does.

Corner stencils are fetched as one flat (n,) gather per vertex rather than a
single (n, 2^N)-shaped gather: flat gathers with constant offsets fuse into
the downstream elementwise tree. The layout was chosen on a TPU, whose
compiler took time proportional to the index count for multi-dimensional
gathers; which layout is faster on a GPU is not measured.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..utils import corner_offsets


def take1(vals, idx):
    """vals[idx] for flat `vals` and integer `idx` of any shape, promising
    in-bounds indices."""
    return jnp.asarray(vals).at[idx].get(mode="promise_in_bounds")


# Small per-axis arrays (65.._TAKE_ONEHOT_MAX entries) are read with a
# branch-free one-hot select-sum instead of a gather; at or below 64 entries
# and above the cap, plain take. These thresholds were set on a TPU, whose
# gather lowering was slow for such arrays; they are not measured on the
# GPU. Above the cap the O(len) per-query compares would lose to a gather
# anyway (value-table gathers keep take1 directly: tables reach 1e6+).
_TAKE_ONEHOT_MAX = 4096


def take_small(vals, idx):
    """vals[idx] for flat `vals` and 1-D in-bounds `idx`: plain take at
    <= 64 entries and above _TAKE_ONEHOT_MAX, a branch-free one-hot
    select-sum between."""
    vals = jnp.asarray(vals)
    n = int(vals.shape[0])
    if n <= 64 or n > _TAKE_ONEHOT_MAX or getattr(idx, "ndim", 1) != 1:
        return take1(vals, idx)
    iota = jnp.arange(n, dtype=jnp.int32)
    mask = idx[:, None].astype(jnp.int32) == iota[None, :]
    return jnp.sum(
        jnp.where(mask, vals[None, :], jnp.zeros((), vals.dtype)), axis=1
    )


# Above this stencil size, per-vertex gathers would bloat the traced program
# (4^N nodes); switch to one batched gather + a vectorized tree reduction.
LIST_MAX_VERTS = 256


def gather_corners(vals, base, dims, footprint: int):
    """Fetch the full 2^N (linear) or 4^N (cubic) corner stencil as a LIST of
    flat gathers, ordered by the reference's vertex counter (dim 0 in the
    lowest bit/digit, `src/multilinear/regular.rs:356-367`).

    Only for stencils up to LIST_MAX_VERTS vertices — every hot configuration
    (linear <= 8D, cubic <= 4D)."""
    offs = corner_offsets(dims, footprint)
    return [take1(vals, base if o == 0 else base + int(o)) for o in offs]


def gather_corners_matrix(vals, base, dims, footprint: int):
    """Fetch the corner stencil as one (n_verts, n) array, vertex-major.

    Used for the large-stencil tail (cubic 5-8D): a single batched gather
    keeps the traced program small for these rare configurations."""
    offs = jnp.asarray(corner_offsets(dims, footprint))
    idx = offs[:, None] + base[None, :]
    return take1(vals, idx)
