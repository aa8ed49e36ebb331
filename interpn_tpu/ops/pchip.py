"""Tensor-product PCHIP (monotone cubic Hermite), batched over queries.

Beyond-reference capability: the reference library has no monotone cubic
(`src/multicubic/mod.rs:1-46` discusses only the centered-difference Hermite
family), but scipy's `RegularGridInterpolator` ships a `pchip` method and
migrating scipy users ask for it — it is the standard choice when the data
must not overshoot (monotonicity-preserving, Fritsch-Carlson/Moler slopes).

Semantics match scipy 1.17 exactly (probed, not copied):

* Per-axis slopes are PCHIP derivatives — zero at local extrema /
  sign changes, else the weighted harmonic mean
  ``(w1 + w2) / (w1/m_left + w2/m_right)`` with ``w1 = 2*h_right + h_left``,
  ``w2 = h_right + 2*h_left``; grid-boundary nodes use the one-sided
  three-point estimate with Moler's monotonicity clamps.
* N-d evaluation applies the 1D interpolant axis-by-axis, LAST axis first —
  scipy's recursion order, which matters because PCHIP is nonlinear in the
  data (unlike multilinear/multicubic, where order only permutes fp error).
* Out-of-bounds queries extrapolate the edge interval's cubic polynomial
  (scipy's ``extrapolate=True``); bounds/fill policies live in the callers.

PCHIP slopes depend on the data only through a 4-point window: the slope at
a node needs the two adjacent differences, so evaluating any interval needs
values at ``i-1..i+2`` (clamped at the edges, where the one-sided formula
needs exactly the 3 boundary points). The evaluation therefore reuses the
cubic engines' 4^N gather-tree machinery (`ops/_gather.py`) with a
PCHIP-specific axis reduction — reduced in REVERSED axis order by grouping
the stencil list's top base-4 digit. Because the slopes are nonlinear in the
values, no basis-weight extraction exists and there is no factorized
form; the gather tree is the engine on every backend (each axis reduction is
elementwise over queries, so it vectorizes and shards like the cubic tree).

Grids need at least 4 points per axis (scipy's own `pchip` minimum).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..utils import c_strides
from ._chunk import chunk_queries
from ._gather import LIST_MAX_VERTS, gather_corners, gather_corners_matrix
from .cubic import _hermite
from .locate import locate_regular_cubic, locate_rectilinear_cubic

_I32 = jnp.int32


def _interior_slope(hl, hr, ml, mr):
    """PCHIP derivative at the node between diffs ml (left) and mr (right).

    Zero when the diffs vanish or disagree in sign, else the weighted
    harmonic mean (scipy ``PchipInterpolator._find_derivatives``)."""
    cond = (jnp.sign(ml) != jnp.sign(mr)) | (mr == 0) | (ml == 0)
    one = jnp.ones((), dtype=ml.dtype)
    w1 = 2.0 * hr + hl
    w2 = hr + 2.0 * hl
    # guard the divisions `where` still evaluates on the masked lanes
    sl = jnp.where(cond, one, ml)
    sr = jnp.where(cond, one, mr)
    return jnp.where(cond, 0.0, (w1 + w2) / (w1 / sl + w2 / sr))


def _edge_slope(h0, h1, m0, m1):
    """One-sided three-point boundary derivative with Moler's clamps
    (scipy ``PchipInterpolator._edge_case``): h0/m0 belong to the boundary
    interval, h1/m1 to its neighbor."""
    d = ((2.0 * h0 + h1) * m0 - h0 * m1) / (h0 + h1)
    zero_it = jnp.sign(d) != jnp.sign(m0)
    clamp_it = (jnp.sign(m0) != jnp.sign(m1)) & (jnp.abs(d) > 3.0 * jnp.abs(m0))
    return jnp.where(zero_it, 0.0, jnp.where(clamp_it, 3.0 * m0, d))


def _select3(low, high, a, b, c):
    """a / b / c on the low-edge / interior / high-edge interval."""
    return jnp.where(low, a, jnp.where(high, c, b))


def _axis_reduce_pchip_regular(v, t, low, high):
    """One PCHIP node on a regular grid, normalized units (h == 1).

    v is the 4-point stencil; t the coordinate relative to stencil index 1
    (`locate_regular_cubic`). `low`/`high` flag the boundary intervals —
    the clamped stencil guarantees low <=> interval [v0, v1] is the grid's
    first and high <=> [v2, v3] is its last, so the edge formulas apply
    exactly where scipy applies them.
    """
    v0, v1, v2, v3 = v
    m0 = v1 - v0
    m1 = v2 - v1
    m2 = v3 - v2
    one = jnp.ones((), dtype=m0.dtype)
    s1 = _interior_slope(one, one, m0, m1)  # node 1
    s2 = _interior_slope(one, one, m1, m2)  # node 2
    e0 = _edge_slope(one, one, m0, m1)  # node 0 == grid node 0
    e3 = _edge_slope(one, one, m2, m1)  # node 3 == grid node n-1

    tt = t + _select3(low, high, 1.0, 0.0, -1.0)
    yl = _select3(low, high, v0, v1, v2)
    yr = _select3(low, high, v1, v2, v3)
    k0 = _select3(low, high, e0, s1, s2)
    k1 = _select3(low, high, s1, s2, e3)
    res = _hermite(tt, yl, yr - yl, k0, k1)
    # exact node reproduction (house contract, cf. _axis_reduce_regular)
    return jnp.where(tt == 0.0, yl, jnp.where(tt == 1.0, yr, res))


def _axis_reduce_pchip_rect(v, x, gc, low, high):
    """One PCHIP node on a rectilinear grid (real spacings)."""
    v0, v1, v2, v3 = v
    g0, g1, g2, g3 = gc
    h0 = g1 - g0
    h1 = g2 - g1
    h2 = g3 - g2
    m0 = (v1 - v0) / h0
    m1 = (v2 - v1) / h1
    m2 = (v3 - v2) / h2
    s1 = _interior_slope(h0, h1, m0, m1)
    s2 = _interior_slope(h1, h2, m1, m2)
    e0 = _edge_slope(h0, h1, m0, m1)
    e3 = _edge_slope(h2, h1, m2, m1)

    yl = _select3(low, high, v0, v1, v2)
    yr = _select3(low, high, v1, v2, v3)
    xl = _select3(low, high, g0, g1, g2)
    h = _select3(low, high, h0, h1, h2)
    dl = _select3(low, high, e0, s1, s2)
    dr = _select3(low, high, s1, s2, e3)
    tt = (x - xl) / h
    res = _hermite(tt, yl, yr - yl, dl * h, dr * h)
    return jnp.where(tt == 0.0, yl, jnp.where(tt == 1.0, yr, res))


def pchip_regular(dims: tuple[int, ...], starts, steps, vals, obs):
    """Tensor-product PCHIP eval on a regular grid (1..8 dims, >= 4 points
    per axis). Matches scipy RGI ``method='pchip'`` including edge-interval
    extrapolation; see the module docstring for the recursion order."""
    ndims = len(dims)
    if 4**ndims > LIST_MAX_VERTS and getattr(obs[0], "ndim", 1) == 1:
        return chunk_queries(
            lambda ob: _pchip_regular_impl(dims, starts, steps, vals, ob),
            obs, 4**ndims, jnp.asarray(vals).dtype.itemsize,
        )
    return _pchip_regular_impl(dims, starts, steps, vals, obs)


def _pchip_regular_impl(dims, starts, steps, vals, obs):
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
        # reduce the LAST axis first (scipy's order; load-bearing for a
        # value-nonlinear interpolant): the vertex list carries dim 0 in the
        # lowest base-4 digit, so each level groups by the TOP digit.
        for cl in reversed(per_dim):
            q = len(c) // 4
            c = [
                _axis_reduce_pchip_regular(
                    (c[j], c[j + q], c[j + 2 * q], c[j + 3 * q]),
                    cl.t, cl.low, cl.high,
                )
                for j in range(q)
            ]
        return c[0]

    # Large-stencil tail (5-8D): vectorize the tree over the vertex axis.
    c = gather_corners_matrix(vals, base, dims, 4)
    for cl in reversed(per_dim):
        g = c.reshape(4, c.shape[0] // 4, *c.shape[1:])
        c = _axis_reduce_pchip_regular(
            (g[0], g[1], g[2], g[3]), cl.t, cl.low, cl.high
        )
    return c[0]


def pchip_rectilinear(grids, vals, obs):
    """Tensor-product PCHIP eval on a rectilinear grid (1..8 dims, >= 4
    points per axis); scipy RGI ``method='pchip'`` semantics."""
    ndims = len(grids)
    if 4**ndims > LIST_MAX_VERTS and getattr(obs[0], "ndim", 1) == 1:
        return chunk_queries(
            lambda ob: _pchip_rectilinear_impl(grids, vals, ob),
            obs, 4**ndims, jnp.asarray(vals).dtype.itemsize,
        )
    return _pchip_rectilinear_impl(grids, vals, obs)


def _pchip_rectilinear_impl(grids, vals, obs):
    ndims = len(grids)
    dims = tuple(int(g.shape[0]) for g in grids)
    strides = c_strides(dims)
    base = jnp.zeros(obs[0].shape, dtype=_I32)
    per_dim = []
    for k in range(ndims):
        cl, gc = locate_rectilinear_cubic(obs[k], grids[k])
        base = base + cl.loc * strides[k]
        per_dim.append((cl, gc, obs[k]))
    if 4**ndims <= LIST_MAX_VERTS:
        c = gather_corners(vals, base, dims, 4)
        for cl, gct, x in reversed(per_dim):
            q = len(c) // 4
            c = [
                _axis_reduce_pchip_rect(
                    (c[j], c[j + q], c[j + 2 * q], c[j + 3 * q]),
                    x, gct, cl.low, cl.high,
                )
                for j in range(q)
            ]
        return c[0]

    c = gather_corners_matrix(vals, base, dims, 4)
    for cl, gct, x in reversed(per_dim):
        g = c.reshape(4, c.shape[0] // 4, *c.shape[1:])
        c = _axis_reduce_pchip_rect(
            (g[0], g[1], g[2], g[3]), x, gct, cl.low, cl.high
        )
    return c[0]


_JIT_CACHE: dict = {}


def jitted(kind: str):
    """Lazily-jitted evaluator for one grid kind, shared across callers
    (`interpn(method="pchip")`, the scipy adapter): jax caches compiled
    executables per grid/batch shape under the one traced function."""
    fn = _JIT_CACHE.get(kind)
    if fn is None:
        import jax

        if kind == "regular":
            fn = jax.jit(pchip_regular, static_argnums=0)
        else:
            fn = jax.jit(pchip_rectilinear)
        _JIT_CACHE[kind] = fn
    return fn
