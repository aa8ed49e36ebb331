"""Engine selection: the gather tree or the factorized contraction.

Two device implementations cover every method x grid-kind family:

* `gather` (ops.linear / ops.cubic / ops.nearest): per-vertex flat gathers
  + tree reduction. Matches the reference's evaluation order, touches only
  the stencil, and differentiates and batches natively.
* `factorized` (ops.factorized): per-axis dense weight matrices contracted
  with XLA einsums. It costs 2*n*prod(dims) FLOPs per call, and one
  non-finite table value poisons every query (0 * inf = nan).

Auto selection is the gather tree. The choice is made at trace time from
what the call carries (the override and the table's finiteness), never
from the backend's name. `INTERPN_TPU_IMPL=gather|factorized` forces an
engine; a forced factorized call whose table holds inf/NaN still runs the
gather tree, so the override changes speed and never the result.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from . import factorized as _fz
from .cubic import cubic_rectilinear as _cubic_rect_gather
from .cubic import cubic_regular as _cubic_reg_gather
from .linear import linear_rectilinear as _linear_rect_gather
from .linear import linear_regular as _linear_reg_gather
from .nearest import nearest_rectilinear as _nearest_rect_gather
from .nearest import nearest_regular as _nearest_reg_gather

IMPL_MODES = ("auto", "gather", "factorized")


def impl_mode() -> str:
    """The `INTERPN_TPU_IMPL` override, read per trace."""
    mode = os.environ.get("INTERPN_TPU_IMPL", "auto")
    if mode not in IMPL_MODES:
        raise ValueError(
            f"INTERPN_TPU_IMPL={mode!r}: expected one of {', '.join(IMPL_MODES)}"
        )
    return mode


def _vals_finite(vals) -> bool:
    """Best-effort trace-time finiteness check of the grid values.

    Concrete arrays are checked here; traced values cannot be inspected,
    so jit callers thread the flag in from the host (see raw.py / models)
    or accept the documented caveat of the forced factorized engine."""
    if isinstance(vals, jax.core.Tracer):
        return True
    try:
        return bool(jnp.isfinite(vals).all())
    except (TypeError, jax.errors.TracerBoolConversionError):
        return True


def _impl(vals, vals_finite) -> str:
    """Pick the engine for one trace."""
    if impl_mode() != "factorized":
        return "gather"
    finite = _vals_finite(vals) if vals_finite is None else bool(vals_finite)
    return "factorized" if finite else "gather"


def nearest_regular(dims, starts, steps, vals, obs, *, vals_finite=None):
    if _impl(vals, vals_finite) == "factorized":
        return _fz.nearest_regular_factorized(dims, starts, steps, vals, obs)
    return _nearest_reg_gather(dims, starts, steps, vals, obs)


def nearest_rectilinear(grids, vals, obs, *, vals_finite=None):
    if _impl(vals, vals_finite) == "factorized":
        return _fz.nearest_rectilinear_factorized(grids, vals, obs)
    return _nearest_rect_gather(grids, vals, obs)


def linear_regular(dims, starts, steps, vals, obs, *, vals_finite=None):
    if _impl(vals, vals_finite) == "factorized":
        return _fz.linear_regular_factorized(dims, starts, steps, vals, obs)
    return _linear_reg_gather(dims, starts, steps, vals, obs)


def linear_rectilinear(grids, vals, obs, *, vals_finite=None):
    if _impl(vals, vals_finite) == "factorized":
        return _fz.linear_rectilinear_factorized(grids, vals, obs)
    return _linear_rect_gather(grids, vals, obs)


def cubic_regular(
    dims, starts, steps, vals, obs, linearize_extrapolation: bool, *, vals_finite=None
):
    if _impl(vals, vals_finite) == "factorized":
        return _fz.cubic_regular_factorized(
            dims, starts, steps, vals, obs, linearize_extrapolation
        )
    return _cubic_reg_gather(dims, starts, steps, vals, obs, linearize_extrapolation)


def cubic_rectilinear(grids, vals, obs, linearize_extrapolation: bool, *, vals_finite=None):
    if _impl(vals, vals_finite) == "factorized":
        return _fz.cubic_rectilinear_factorized(
            grids, vals, obs, linearize_extrapolation
        )
    return _cubic_rect_gather(grids, vals, obs, linearize_extrapolation)
