"""Multicubic (Hermite) interpolation/extrapolation, batched over queries.

Batched re-design of the reference's cubic kernels
(`src/multicubic/regular.rs:325-623`, `src/multicubic/rectilinear.rs:265-545`,
shared math `src/multicubic/mod.rs:68-117`):

* The 4^N stencil is fetched as one flat gather per vertex with a
  compile-time-constant offset (see `ops/_gather.py` for this layout),
  ordered by the reference's base-4 digit pattern.
* The per-axis Hermite evaluation — the reference's 5-way `Saturation` match —
  is flattened into branchless `where`-selects. All five cases share the same
  `normalized_hermite_spline` shape; only (t, y0, dy, k0, k1) differ:
    None:        t'=t,   y0=v1, dy=v2-v1, k0=(v2-v0)/2,  k1=(v3-v1)/2
    Inside/OutsideLow (mirrored): t'=-t, y0=v1, dy=v0-v1,
                 k0=-(v2-v0)/2, k1=2*dy-k0 (natural-spline BC)
    Inside/OutsideHigh: t'=t-1, y0=v2, dy=v3-v2, k0=(v3-v1)/2, k1=2*dy-k0
  With `linearize_extrapolation`, the two Outside cases become
  y_edge + k1*(t'-1) instead of the spline (`regular.rs:553-561,609-617`).
* The dependency tree reduces groups of 4 adjacent list entries per level —
  dimension 0 first, dimension N-1 last, matching the reference's evaluation
  order (`regular.rs:368-412`).

The rectilinear variant additionally carries the 4 bracketing grid coordinates
per dimension and uses the distance-weighted nonuniform centered difference
(Veldman & Rinzema method B, `mod.rs:94-117`) with the same h-ratio
normalizations as `rectilinear.rs:446-452,467-473,512-517`.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..utils import c_strides
from ._chunk import chunk_queries
from ._gather import LIST_MAX_VERTS, gather_corners, gather_corners_matrix
from .locate import locate_regular_cubic, locate_rectilinear_cubic

_I32 = jnp.int32


def _hermite(t, y0, dy, k0, k1):
    """Normalized cubic Hermite spline via Horner (`mod.rs:72-91`)."""
    a = k0 - dy
    b = -k1 + dy
    c1 = dy + a
    c2 = b - (a + a)
    c3 = a - b
    return y0 + t * (c1 + t * (c2 + t * c3))


def _centered_diff_nonuniform(y0, y1, y2, h01, h12):
    """Distance-weighted central difference on a nonuniform grid
    (`mod.rs:103-117`)."""
    a = h01 / (h01 + h12)
    b = (y2 - y1) / h12
    c = h12 / (h12 + h01)
    d = (y1 - y0) / h01
    return a * b + c * d


def _axis_reduce_regular(v, t, low, high, outside, linearize: bool):
    """One node of the cubic dependency tree on a regular grid.

    v is a tuple of 4 per-point arrays. Vectorized form of `interp_inner`
    (`src/multicubic/regular.rs:472-623`).
    """
    v0, v1, v2, v3 = v
    tt = jnp.where(low, -t, jnp.where(high, t - 1.0, t))
    y0 = jnp.where(high, v2, v1)
    dy = jnp.where(low, v0 - v1, jnp.where(high, v3 - v2, v2 - v1))
    half02 = (v2 - v0) * 0.5
    half13 = (v3 - v1) * 0.5
    k0 = jnp.where(low, -half02, jnp.where(high, half13, half02))
    k1 = jnp.where(low | high, 2.0 * dy - k0, half13)
    res = _hermite(tt, y0, dy, k0, k1)
    if linearize:
        y_edge = jnp.where(low, v0, v3)
        lin = y_edge + k1 * (tt - 1.0)
        res = jnp.where(outside, lin, res)
    # Exact node reproduction: at tt == 0/1 return the endpoint values
    # bit-for-bit (matches the native backend and the reference's
    # grid-node-equality tests).
    endpoint = jnp.where(low, v0, jnp.where(high, v3, v2))
    return jnp.where(tt == 0.0, y0, jnp.where(tt == 1.0, endpoint, res))


def _axis_reduce_rectilinear(v, x, gc, low, high, outside, linearize: bool):
    """One node of the cubic tree on a rectilinear grid.

    v is a tuple of 4 per-point arrays; gc a tuple of the 4 bracketing grid
    coordinates. Vectorized form of the rectilinear `interp_inner`
    (`src/multicubic/rectilinear.rs:411-545`).
    """
    v0, v1, v2, v3 = v
    g0, g1, g2, g3 = gc
    h01 = g1 - g0
    h12 = g2 - g1
    h23 = g3 - g2
    one = jnp.ones((), dtype=x.dtype)

    # Slopes per case (same operand normalizations as the reference).
    k0_none = _centered_diff_nonuniform(v0, v1, v2, h01 / h12, one)
    k1_none = _centered_diff_nonuniform(v1, v2, v3, one, h23 / h12)
    k0_low = -_centered_diff_nonuniform(v0, v1, v2, one, h12 / h01)
    k0_high = _centered_diff_nonuniform(v1, v2, v3, h12 / h23, one)

    dy = jnp.where(low, v0 - v1, jnp.where(high, v3 - v2, v2 - v1))
    y0 = jnp.where(high, v2, v1)
    k0 = jnp.where(low, k0_low, jnp.where(high, k0_high, k0_none))
    k1 = jnp.where(low | high, 2.0 * dy - k0, k1_none)

    # Normalized coordinate per case: None (x-g1)/h12; low -(x-g1)/h01
    # (mirrored); high (x-g2)/h23.
    tt = jnp.where(
        low,
        -(x - g1) / h01,
        jnp.where(high, (x - g2) / h23, (x - g1) / h12),
    )

    res = _hermite(tt, y0, dy, k0, k1)
    if linearize:
        y_edge = jnp.where(low, v0, v3)
        lin = y_edge + k1 * (tt - 1.0)
        res = jnp.where(outside, lin, res)
    # Exact node reproduction (see the regular-grid variant above).
    endpoint = jnp.where(low, v0, jnp.where(high, v3, v2))
    return jnp.where(tt == 0.0, y0, jnp.where(tt == 1.0, endpoint, res))


def cubic_regular(
    dims: tuple[int, ...], starts, steps, vals, obs, linearize_extrapolation: bool
):
    """Multicubic eval on a regular grid (1..8 dims).

    Matches `multicubic::regular::interpn` (`src/multicubic/regular.rs:52-135`)
    including quadratic continuation / linearized extrapolation semantics.

    5-8D stencils (4^N > LIST_MAX_VERTS) fetch a (4^N, n) corner matrix;
    flat query batches are chunked so that temporary stays bounded (5D f64
    at 1M queries would otherwise materialize 8 GB at once).
    """
    ndims = len(dims)
    if 4**ndims > LIST_MAX_VERTS and getattr(obs[0], "ndim", 1) == 1:
        return chunk_queries(
            lambda ob: _cubic_regular_impl(
                dims, starts, steps, vals, ob, linearize_extrapolation
            ),
            obs, 4**ndims, jnp.asarray(vals).dtype.itemsize,
        )
    return _cubic_regular_impl(
        dims, starts, steps, vals, obs, linearize_extrapolation
    )


def _cubic_regular_impl(dims, starts, steps, vals, obs, linearize_extrapolation):
    ndims = len(dims)
    strides = c_strides(dims)
    base = jnp.zeros(obs[0].shape, dtype=_I32)
    per_dim = []
    for k in range(ndims):
        cl = locate_regular_cubic(obs[k], starts[k], steps[k], dims[k])
        base = base + cl.loc * strides[k]
        per_dim.append(cl)
    if 4**ndims <= LIST_MAX_VERTS:
        c = gather_corners(vals, base, dims, 4)
        for cl in per_dim:
            c = [
                _axis_reduce_regular(
                    (c[4 * j], c[4 * j + 1], c[4 * j + 2], c[4 * j + 3]),
                    cl.t,
                    cl.low,
                    cl.high,
                    cl.outside,
                    linearize_extrapolation,
                )
                for j in range(len(c) // 4)
            ]
        return c[0]

    # Large-stencil tail (5-8D): vectorize the tree over the vertex axis.
    c = gather_corners_matrix(vals, base, dims, 4)
    for cl in per_dim:
        g = c.reshape(c.shape[0] // 4, 4, *c.shape[1:])
        c = _axis_reduce_regular(
            (g[:, 0], g[:, 1], g[:, 2], g[:, 3]),
            cl.t,
            cl.low,
            cl.high,
            cl.outside,
            linearize_extrapolation,
        )
    return c[0]


def cubic_rectilinear(grids, vals, obs, linearize_extrapolation: bool):
    """Multicubic eval on a rectilinear grid (1..8 dims).

    Matches `multicubic::rectilinear::interpn`
    (`src/multicubic/rectilinear.rs`), with slopes from distance-weighted
    nonuniform centered differences. 5-8D flat batches are chunked like
    `cubic_regular`.
    """
    ndims = len(grids)
    if 4**ndims > LIST_MAX_VERTS and getattr(obs[0], "ndim", 1) == 1:
        return chunk_queries(
            lambda ob: _cubic_rectilinear_impl(
                grids, vals, ob, linearize_extrapolation
            ),
            obs, 4**ndims, jnp.asarray(vals).dtype.itemsize,
        )
    return _cubic_rectilinear_impl(grids, vals, obs, linearize_extrapolation)


def _cubic_rectilinear_impl(grids, vals, obs, linearize_extrapolation):
    ndims = len(grids)
    dims = tuple(int(g.shape[0]) for g in grids)
    strides = c_strides(dims)
    base = jnp.zeros(obs[0].shape, dtype=_I32)
    per_dim = []
    for k in range(ndims):
        cl, gc = locate_rectilinear_cubic(obs[k], grids[k])
        base = base + cl.loc * strides[k]
        per_dim.append((cl, gc))
    if 4**ndims <= LIST_MAX_VERTS:
        c = gather_corners(vals, base, dims, 4)
        for k in range(ndims):
            cl, gct = per_dim[k]
            c = [
                _axis_reduce_rectilinear(
                    (c[4 * j], c[4 * j + 1], c[4 * j + 2], c[4 * j + 3]),
                    obs[k],
                    gct,
                    cl.low,
                    cl.high,
                    cl.outside,
                    linearize_extrapolation,
                )
                for j in range(len(c) // 4)
            ]
        return c[0]

    # Large-stencil tail (5-8D): vectorize the tree over the vertex axis.
    c = gather_corners_matrix(vals, base, dims, 4)
    for k in range(ndims):
        cl, gct = per_dim[k]
        g = c.reshape(c.shape[0] // 4, 4, *c.shape[1:])
        c = _axis_reduce_rectilinear(
            (g[:, 0], g[:, 1], g[:, 2], g[:, 3]),
            obs[k],
            gct,
            cl.low,
            cl.high,
            cl.outside,
            linearize_extrapolation,
        )
    return c[0]
