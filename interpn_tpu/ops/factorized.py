"""Factorized evaluation path: interpolation as per-axis contractions.

Every method in this library is a LINEAR functional of the grid values: the
result is sum over the stencil of vals[corner] * prod_k w_k[digit_k], where
the per-axis weight vector w_k depends only on (t_k, saturation_k). The
gather formulation fetches the 2^N/4^N corners per query. This module
instead builds, per axis, a dense weight matrix W_k of shape (n, dims[k]) —
zero except at the stencil footprint — and contracts:

    y = einsum('qa,a...->q...', W_0, vals.reshape(dims))   # matmul
    y = einsum('qb,qb...->q...', W_k, y)   for k = 1..N-1  # mul+reduce

The first contraction is a real (n, d0) x (d0, rest) matmul; later ones are
batched multiply-reduces. Total FLOPs are 2*n*prod(dims) — independent of
the stencil size, so cubic costs the same as linear here, but compute
scales with the grid size. It was built for a matrix unit; dispatch
selects it only when forced (ops/dispatch.py).

Caveat: contraction-based evaluation multiplies every grid value by its
weight (zero off-stencil); non-finite values anywhere in the grid therefore
poison the result (0 * inf = nan), unlike the gather path which touches only
the stencil. The dispatcher runs the gather tree for such tables.

Weight extraction is exact-by-construction: the cubic per-axis weights are
obtained by evaluating the same saturation-aware node function used by the
gather path on the four unit basis vectors (linearity of the Hermite
construction in the stencil values), so both paths implement identical
mathematics and differ only in floating-point association order.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ._chunk import chunk_queries
from .cubic import _axis_reduce_regular, _axis_reduce_rectilinear
from .locate import (
    locate_regular_cubic,
    locate_regular_linear,
    locate_rectilinear_cubic,
    locate_rectilinear_linear,
)

_I32 = jnp.int32


# The first contraction materializes an (n_chunk, prod(dims[1:])) temporary;
# bound it to ~this many bytes by chunking the query axis (see ops/_chunk.py).
_CHUNK_BYTES = 2 * 1024 * 1024 * 1024


def _chunk_queries(f, obs, rest: int, itemsize: int):
    """Evaluate f over query chunks sized to bound the contraction temp."""
    return chunk_queries(f, obs, rest, itemsize, _CHUNK_BYTES)


def _scatter_weights(loc, ws, dim: int):
    """Dense (n, dim) weight matrix with ws[i] placed at column loc+i."""
    iota = jnp.arange(dim, dtype=_I32)
    cols = loc[:, None]
    w = None
    for i, wi in enumerate(ws):
        term = jnp.where(iota == cols + i, wi[:, None], 0)
        w = term if w is None else w + term
    return w


def _basis_weights_cubic_regular(cl, linearize: bool):
    """Per-axis cubic weights via the node function on unit bases."""
    dtype = cl.t.dtype
    zero = jnp.zeros((), dtype)
    one = jnp.ones((), dtype)
    ws = []
    for i in range(4):
        e = tuple(one if j == i else zero for j in range(4))
        ws.append(
            _axis_reduce_regular(e, cl.t, cl.low, cl.high, cl.outside, linearize)
        )
    return ws


def _basis_weights_cubic_rectilinear(cl, gct, x, linearize: bool):
    dtype = x.dtype
    zero = jnp.zeros((), dtype)
    one = jnp.ones((), dtype)
    ws = []
    for i in range(4):
        e = tuple(one if j == i else zero for j in range(4))
        ws.append(
            _axis_reduce_rectilinear(
                e, x, gct, cl.low, cl.high, cl.outside, linearize
            )
        )
    return ws


# Maximum contraction width when grouping leading axes into one matmul.
_MAX_GROUPED_K = 2048


def _split_point(dims) -> int:
    """Number of leading axes to fold into the first matmul.

    Choose the split minimizing the dominant per-query traffic
    (combined weight width + first intermediate width); ties prefer fewer
    grouped axes. For a 20^4 grid this groups two axes (K=400, rest=400)
    instead of paying an (n, 8000) intermediate that must be chunked."""
    best_p, best_cost = 1, None
    k = 1
    rest = math.prod(dims)
    for p in range(1, len(dims) + 1):
        k *= dims[p - 1]
        rest //= dims[p - 1]
        if k > _MAX_GROUPED_K and p > 1:
            break
        cost = (k if p > 1 else 0) + rest  # wlead materializes only if p>1
        if best_cost is None or cost < best_cost:
            best_p, best_cost = p, cost
    return best_p


def _max_row_width(dims) -> int:
    """Widest per-query row materialized by the grouped contraction (used
    to size query chunks)."""
    p = _split_point(dims)
    k = math.prod(dims[:p])
    rest = math.prod(dims[p:])
    return max(k if p > 1 else 0, rest, 1)


def _contract(weight_mats, vals, dims):
    """Apply the per-axis contractions; weight_mats[k] is (n, dims[k]).

    precision=HIGHEST is load-bearing: a default-precision f32 matmul may
    run in a reduced-precision mode (TF32 on a GPU's tensor cores keeps
    about three decimal digits), far outside the f32 tolerance. HIGHEST
    keeps full f32."""
    dtype = vals.dtype
    n = weight_mats[0].shape[0]
    hp = jax.lax.Precision.HIGHEST

    p = _split_point(dims)
    wlead = weight_mats[0]
    for k in range(1, p):
        wlead = (wlead[:, :, None] * weight_mats[k][:, None, :]).reshape(n, -1)
    ksize = math.prod(dims[:p])

    y = jnp.einsum(
        "qa,ar->qr", wlead, vals.reshape(ksize, -1),
        preferred_element_type=dtype, precision=hp,
    )
    for k in range(p, len(dims)):
        rest = y.shape[1] // dims[k]
        y = y.reshape(n, dims[k], rest)
        y = jnp.einsum("qbr,qb->qr", y, weight_mats[k], precision=hp)
    return y.reshape(n)


def linear_regular_factorized(dims, starts, steps, vals, obs):
    """Multilinear, regular grid, factorized path (same locate semantics as
    `ops.linear.linear_regular`)."""

    def run(ob):
        mats = []
        for k in range(len(dims)):
            loc, t = locate_regular_linear(ob[k], starts[k], steps[k], dims[k])
            mats.append(_scatter_weights(loc, [1.0 - t, t], dims[k]))
        return _contract(mats, vals, dims)

    return _chunk_queries(run, obs, _max_row_width(dims), vals.dtype.itemsize)


def linear_rectilinear_factorized(grids, vals, obs):
    dims = tuple(int(g.shape[0]) for g in grids)

    def run(ob):
        mats = []
        for k in range(len(dims)):
            loc, x0, x1 = locate_rectilinear_linear(ob[k], grids[k])
            t = (ob[k] - x0) / (x1 - x0)
            mats.append(_scatter_weights(loc, [1.0 - t, t], dims[k]))
        return _contract(mats, vals, dims)

    return _chunk_queries(run, obs, _max_row_width(dims), vals.dtype.itemsize)


def nearest_regular_factorized(dims, starts, steps, vals, obs):
    """Nearest-neighbor as a one-hot contraction (the weight vector has a
    single 1 at the selected index per axis)."""

    def run(ob):
        mats = []
        for k in range(len(dims)):
            loc, dt = locate_regular_linear(ob[k], starts[k], steps[k], dims[k])
            sel = loc + jnp.where(dt <= 0.5, 0, 1).astype(loc.dtype)
            one = jnp.ones_like(dt)
            mats.append(_scatter_weights(sel, [one], dims[k]))
        return _contract(mats, vals, dims)

    return _chunk_queries(run, obs, _max_row_width(dims), vals.dtype.itemsize)


def nearest_rectilinear_factorized(grids, vals, obs):
    dims = tuple(int(g.shape[0]) for g in grids)

    def run(ob):
        mats = []
        for k in range(len(dims)):
            loc, x0, x1 = locate_rectilinear_linear(ob[k], grids[k])
            dt = (ob[k] - x0) / (x1 - x0)
            sel = loc + jnp.where(dt <= 0.5, 0, 1).astype(loc.dtype)
            one = jnp.ones_like(dt)
            mats.append(_scatter_weights(sel, [one], dims[k]))
        return _contract(mats, vals, dims)

    return _chunk_queries(run, obs, _max_row_width(dims), vals.dtype.itemsize)


def cubic_regular_factorized(dims, starts, steps, vals, obs, linearize: bool):
    def run(ob):
        mats = []
        for k in range(len(dims)):
            cl = locate_regular_cubic(ob[k], starts[k], steps[k], dims[k])
            ws = _basis_weights_cubic_regular(cl, linearize)
            mats.append(_scatter_weights(cl.loc, ws, dims[k]))
        return _contract(mats, vals, dims)

    return _chunk_queries(run, obs, _max_row_width(dims), vals.dtype.itemsize)


def cubic_rectilinear_factorized(grids, vals, obs, linearize: bool):
    dims = tuple(int(g.shape[0]) for g in grids)

    def run(ob):
        mats = []
        for k in range(len(dims)):
            cl, gct = locate_rectilinear_cubic(ob[k], grids[k])
            ws = _basis_weights_cubic_rectilinear(cl, gct, ob[k], linearize)
            mats.append(_scatter_weights(cl.loc, ws, dims[k]))
        return _contract(mats, vals, dims)

    return _chunk_queries(run, obs, _max_row_width(dims), vals.dtype.itemsize)
