"""Multilinear interpolation/extrapolation, batched over query points.

Batched re-design of the reference's flattened-tree kernels
(`src/multilinear/regular.rs:296-404`, `src/multilinear/rectilinear.rs:244-346`):

* All 2^N corner values are fetched with ONE batched gather: the flat base
  index of the lower corner is combined with a static stencil-offset vector
  (the bit-pattern indexing of `regular.rs:356-367`, made into compile-time
  constants), so XLA sees a single (n, 2^N) gather instead of per-point loops.
* Evaluation then reduces the corner tensor one dimension at a time with the
  same repeated-lerp dependency tree as the reference — dim 0 first, dim N-1
  last — preserving its floating-point behavior (exact at t=0/t=1 grid lines).
* Extrapolation is implicit: the locate step clamps to the edge cell and the
  lerp runs with t outside [0, 1]; there is no branch anywhere on this path.

Functions are specialized per (ndims, grid shape) at trace time — the analogue
of the reference's const-generic dispatch (`regular.rs:64-114`) — and are
dtype-generic over f32/f64.
"""

from __future__ import annotations

import jax.numpy as jnp

from ._gather import gather_corners

from ..utils import c_strides
from .locate import locate_regular_linear, locate_rectilinear_linear

_I32 = jnp.int32


def _lerp_reduce(corners, ts):
    """Collapse the corner list with repeated 1D lerps.

    Pairs adjacent list entries (which differ in dimension 0's bit) first —
    the same evaluation order as the reference's flattened tree (level j
    consumes dts[j-1], `regular.rs:368-403`).
    """
    c = corners
    for t in ts:
        c = [y0 + t * (y1 - y0) for y0, y1 in zip(c[0::2], c[1::2])]
    return c[0]


def linear_regular(dims: tuple[int, ...], starts, steps, vals, obs):
    """Multilinear eval on a regular grid.

    Args:
        dims: static grid shape, one entry per dimension (1..8 supported; the
            flattened/recursive split of the reference is unnecessary here —
            XLA specializes per ndims without code-size limits).
        starts: (ndims,) first grid coordinate per dimension.
        steps: (ndims,) grid spacing per dimension (positive).
        vals: flat (prod(dims),) C-order grid values.
        obs: tuple of ndims query-coordinate arrays, all the same shape.

    Returns interpolated/extrapolated values shaped like obs[0].
    """
    ndims = len(dims)
    strides = c_strides(dims)
    base = jnp.zeros(obs[0].shape, dtype=_I32)
    ts = []
    for k in range(ndims):
        loc, t = locate_regular_linear(obs[k], starts[k], steps[k], dims[k])
        base = base + loc * strides[k]
        ts.append(t)
    corners = gather_corners(vals, base, dims, 2)
    return _lerp_reduce(corners, ts)


def linear_rectilinear(grids, vals, obs):
    """Multilinear eval on a rectilinear (monotonic, non-uniform) grid.

    Cell location is a vectorized bisection (searchsorted); the per-dimension
    normalized coordinate t = (x - x0)/(x1 - x0) comes from the bracketing grid
    coordinates exactly as in `rectilinear.rs:309-323`.
    """
    ndims = len(grids)
    dims = tuple(int(g.shape[0]) for g in grids)
    strides = c_strides(dims)
    base = jnp.zeros(obs[0].shape, dtype=_I32)
    ts = []
    for k in range(ndims):
        loc, x0, x1 = locate_rectilinear_linear(obs[k], grids[k])
        base = base + loc * strides[k]
        ts.append((obs[k] - x0) / (x1 - x0))
    corners = gather_corners(vals, base, dims, 2)
    return _lerp_reduce(corners, ts)
