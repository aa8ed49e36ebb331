"""Stacked-table (multi-channel) evaluation dispatch.

Evaluates `nch` value tables that share one grid geometry at the same
observation points, returning an (nch, n) block. The reference has no
analogue — one table per interpolator (`src/multilinear/regular.rs:200-426`,
`src/interpn/multilinear_regular.py:24-212`) — but the workload is common
(vector fields, multi-band lookup tables, ensembles).

Each stack is `jax.vmap` of the single-channel dispatcher (ops.dispatch)
over the channel axis. The channels share the observation arrays, so XLA
computes the per-query cell location and weights once.
"""

from __future__ import annotations

import jax

from . import dispatch as _d

_SINGLE = {
    ("linear", True): lambda dims, g, v, obs, lin, vf: _d.linear_regular(
        dims, *g, v, obs, vals_finite=vf
    ),
    ("nearest", True): lambda dims, g, v, obs, lin, vf: _d.nearest_regular(
        dims, *g, v, obs, vals_finite=vf
    ),
    ("cubic", True): lambda dims, g, v, obs, lin, vf: _d.cubic_regular(
        dims, *g, v, obs, lin, vals_finite=vf
    ),
    ("linear", False): lambda dims, g, v, obs, lin, vf: _d.linear_rectilinear(
        g, v, obs, vals_finite=vf
    ),
    ("nearest", False): lambda dims, g, v, obs, lin, vf: _d.nearest_rectilinear(
        g, v, obs, vals_finite=vf
    ),
    ("cubic", False): lambda dims, g, v, obs, lin, vf: _d.cubic_rectilinear(
        g, v, obs, lin, vals_finite=vf
    ),
}


def _eval_stack(dims, grid_args, vals_stack, obs, method: str, rect: bool,
                linearize: bool, vals_finite):
    single = _SINGLE[(method, not rect)]
    if vals_finite is None and _d.impl_mode() == "factorized":
        # under vmap each channel is a tracer: check the concrete stack here
        vals_finite = _d._vals_finite(vals_stack)
    f = lambda v: single(dims, grid_args, v, obs, linearize, vals_finite)
    return jax.vmap(f)(vals_stack)


def linear_regular_stack(dims, starts, steps, vals_stack, obs, *,
                         vals_finite=None):
    return _eval_stack(
        tuple(dims), (starts, steps), vals_stack, tuple(obs), "linear",
        False, True, vals_finite,
    )


def nearest_regular_stack(dims, starts, steps, vals_stack, obs, *,
                          vals_finite=None):
    return _eval_stack(
        tuple(dims), (starts, steps), vals_stack, tuple(obs), "nearest",
        False, True, vals_finite,
    )


def cubic_regular_stack(dims, starts, steps, vals_stack, obs,
                        linearize_extrapolation: bool = True, *,
                        vals_finite=None):
    return _eval_stack(
        tuple(dims), (starts, steps), vals_stack, tuple(obs), "cubic",
        False, bool(linearize_extrapolation), vals_finite,
    )


def linear_rectilinear_stack(grids, vals_stack, obs, *, vals_finite=None):
    dims = tuple(int(g.shape[0]) for g in grids)
    return _eval_stack(
        dims, tuple(grids), vals_stack, tuple(obs), "linear", True, True,
        vals_finite,
    )


def nearest_rectilinear_stack(grids, vals_stack, obs, *, vals_finite=None):
    dims = tuple(int(g.shape[0]) for g in grids)
    return _eval_stack(
        dims, tuple(grids), vals_stack, tuple(obs), "nearest", True, True,
        vals_finite,
    )


def cubic_rectilinear_stack(grids, vals_stack, obs,
                            linearize_extrapolation: bool = True, *,
                            vals_finite=None):
    dims = tuple(int(g.shape[0]) for g in grids)
    return _eval_stack(
        dims, tuple(grids), vals_stack, tuple(obs), "cubic", True,
        bool(linearize_extrapolation), vals_finite,
    )
