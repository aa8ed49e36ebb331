"""Flat, monomorphized entry points matching the reference's `interpn.raw`.

The reference exposes 16 PyO3 functions (`src/python.rs:13-39`, re-exported by
`src/interpn/raw.py:6-23`); here each one is a thin host-side shim over the
jit-compiled batched kernels in `interpn_tpu.ops`. Names, signatures, argument
order, error type (AssertionError, matching PyO3's PyAssertionError mapping at
`src/python.rs:78`) and error strings are identical to the reference.

Semantics:
* `out` is written in place when it is a numpy array (the reference's
  zero-copy preallocated-output contract). Every function also *returns* the
  result array so device-resident callers can stay on device: pass JAX arrays
  for obs and `out=None`-like usage via the functional `interpn_tpu.ops` API,
  or use these shims with numpy at the boundary.
* Grid metadata (`dims`, and the shapes of grids/vals/obs) is static: XLA
  specializes one executable per (ndims, grid shape, obs length, dtype) — the
  device analogue of the reference's const-generic dispatch.
"""

from __future__ import annotations

import contextlib
import math
import warnings
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import native, ops

# Donation is opportunistic: the one-shot shims donate every freshly-created
# query buffer and XLA reuses (at most) one of them for the output. The
# "not usable" advisory about the remaining ndims-1 buffers is expected —
# but only for THESE calls: the ignore is scoped per invocation (a global
# module-import filter would hide genuine donation failures in user code).
@contextlib.contextmanager
def _quiet_donation():
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", message="Some donated buffers were not usable"
        )
        yield

__all__ = [
    "interpn_linear_regular_f64",
    "interpn_linear_regular_f32",
    "interpn_linear_rectilinear_f64",
    "interpn_linear_rectilinear_f32",
    "interpn_nearest_regular_f64",
    "interpn_nearest_regular_f32",
    "interpn_nearest_rectilinear_f64",
    "interpn_nearest_rectilinear_f32",
    "interpn_cubic_regular_f64",
    "interpn_cubic_regular_f32",
    "interpn_cubic_rectilinear_f64",
    "interpn_cubic_rectilinear_f32",
    "check_bounds_regular_f64",
    "check_bounds_regular_f32",
    "check_bounds_rectilinear_f64",
    "check_bounds_rectilinear_f32",
]

_MAX_DIMS_MSG = (
    "Dimension exceeds maximum (8)."
    " Use interpolator struct directly for higher dimensions."
)


# ---------------------------------------------------------------------------
# jit-compiled cores (cached by JAX per static args + input shapes/dtypes)
# ---------------------------------------------------------------------------


# `vals_finite` is a host-computed static flag: the forced factorized engine
# is only safe when the grid has no inf/NaN sentinels (see ops.dispatch);
# values can't be inspected during tracing, so the flag rides in from the
# shims.
#
# Each core exists in two jit wrappings: the plain one (for callers whose obs
# arrays must stay alive — models.eval_jax hands back user device arrays) and
# a donating one used by the one-shot shims when every obs array was freshly
# created from host data. Donating the obs tuple lets XLA write the output
# into one of the query buffers (same shape/dtype), preserving the
# reference's zero-extra-allocation `out=` contract on device.
#
# REGULAR-grid cores return (result, unrepresentable_flag): the reference's
# regular kernels cast the cell location to isize and error on NaN/inf/
# out-of-range coordinates ("Unrepresentable coordinate value",
# src/multilinear/regular.rs:418, src/multicubic/regular.rs:438,
# src/nearest/regular.rs:309); the flag is one fused elementwise+reduce pass
# over obs inside the same program, and the host shims raise on it.
# Rectilinear kernels bisect instead of casting, so they never error — and
# neither do these (parity).

_TWO63 = 9223372036854775808.0  # 2^63, exactly representable in f32 and f64


def _unrep_flag(starts, steps, obs):
    bad = jnp.zeros((), bool)
    for k, x in enumerate(obs):
        floc = jnp.floor((x - starts[k]) / steps[k])
        ok = (floc >= -_TWO63) & (floc < _TWO63)  # False for NaN too
        bad = bad | (~ok).any()
    return bad


def _linear_regular_impl(dims, starts, steps, vals, obs, vals_finite=True):
    out = ops.linear_regular(dims, starts, steps, vals, obs, vals_finite=vals_finite)
    return out, _unrep_flag(starts, steps, obs)


def _linear_rectilinear_impl(grids, vals, obs, vals_finite=True):
    return ops.linear_rectilinear(grids, vals, obs, vals_finite=vals_finite)


def _nearest_regular_impl(dims, starts, steps, vals, obs, vals_finite=True):
    out = ops.nearest_regular(dims, starts, steps, vals, obs, vals_finite=vals_finite)
    return out, _unrep_flag(starts, steps, obs)


def _nearest_rectilinear_impl(grids, vals, obs, vals_finite=True):
    return ops.nearest_rectilinear(grids, vals, obs, vals_finite=vals_finite)


def _cubic_regular_impl(dims, starts, steps, vals, obs, linearize, vals_finite=True):
    out = ops.cubic_regular(
        dims, starts, steps, vals, obs, linearize, vals_finite=vals_finite
    )
    return out, _unrep_flag(starts, steps, obs)


def _cubic_rectilinear_impl(grids, vals, obs, linearize, vals_finite=True):
    return ops.cubic_rectilinear(
        grids, vals, obs, linearize, vals_finite=vals_finite
    )


_linear_regular = jax.jit(_linear_regular_impl, static_argnums=(0, 5))
_linear_regular_don = jax.jit(
    _linear_regular_impl, static_argnums=(0, 5), donate_argnums=(4,)
)
_linear_rectilinear = jax.jit(_linear_rectilinear_impl, static_argnums=(3,))
_linear_rectilinear_don = jax.jit(
    _linear_rectilinear_impl, static_argnums=(3,), donate_argnums=(2,)
)
_nearest_regular = jax.jit(_nearest_regular_impl, static_argnums=(0, 5))
_nearest_regular_don = jax.jit(
    _nearest_regular_impl, static_argnums=(0, 5), donate_argnums=(4,)
)
_nearest_rectilinear = jax.jit(_nearest_rectilinear_impl, static_argnums=(3,))
_nearest_rectilinear_don = jax.jit(
    _nearest_rectilinear_impl, static_argnums=(3,), donate_argnums=(2,)
)
_cubic_regular = jax.jit(_cubic_regular_impl, static_argnums=(0, 5, 6))
_cubic_regular_don = jax.jit(
    _cubic_regular_impl, static_argnums=(0, 5, 6), donate_argnums=(4,)
)
_cubic_rectilinear = jax.jit(_cubic_rectilinear_impl, static_argnums=(3, 4))
_cubic_rectilinear_don = jax.jit(
    _cubic_rectilinear_impl, static_argnums=(3, 4), donate_argnums=(2,)
)


@partial(jax.jit, static_argnums=(0,))
def _check_bounds_regular(dims, starts, steps, obs, atol):
    return ops.check_bounds_regular(dims, starts, steps, obs, atol)


@jax.jit
def _check_bounds_rectilinear(grids, obs, atol):
    return ops.check_bounds_rectilinear(grids, obs, atol)


# ---------------------------------------------------------------------------
# host-side validation (reference error strings)
# ---------------------------------------------------------------------------


def _require(cond, msg):
    """-O-proof assertion: these checks mirror the reference's RUST-side
    errors (mapped to PyAssertionError by PyO3), which survive python -O;
    plain asserts would not."""
    if not cond:
        raise AssertionError(msg)


def _as_dims(dims) -> tuple[int, ...]:
    return tuple(int(d) for d in np.asarray(dims).ravel())


def _require_dtype(want: np.dtype, pairs):
    """Reference parity: the PyO3 layer's monomorphized signatures refuse
    mismatched inputs outright (`PyReadonlyArray1<T>` extraction raises
    TypeError, `src/python.rs:58-80`) rather than silently casting — the
    f32 entry points would otherwise silently truncate f64 data, and
    non-array inputs (lists) are likewise refused. Device (JAX) arrays are
    accepted when their dtype matches (documented device-array extension)."""
    for name, a in pairs:
        dt = getattr(a, "dtype", None)
        if dt is None:
            raise TypeError(
                f"argument '{name}': expected a {want.name} array,"
                f" got {type(a).__name__}"
            )
        if np.dtype(dt) != want:
            raise TypeError(
                f"argument '{name}': expected a {want.name} array,"
                f" got {np.dtype(dt).name}"
            )


def _check_eval_dtypes(dtype, out, obs, arrays):
    want = np.dtype(np.float64 if dtype == jnp.float64 else np.float32)
    pairs = list(arrays)
    pairs += [("obs", o) for o in obs]
    pairs.append(("out", out))
    _require_dtype(want, pairs)


def _check_bounds_dtypes(dtype, out, obs, arrays):
    want = np.dtype(np.float64 if dtype == jnp.float64 else np.float32)
    pairs = list(arrays)
    pairs += [("obs", o) for o in obs]
    _require_dtype(want, pairs)
    _require_dtype(np.dtype(bool), [("out", out)])


def _size(x) -> int:
    """Element count without forcing a device->host copy."""
    return int(x.size) if hasattr(x, "size") else len(x)


def _validate_regular(dims, starts, steps, vals, obs, out, *, min_size, size_msg):
    ndims = len(dims)
    _require(
        len(starts) == ndims and len(steps) == ndims and len(obs) == ndims,
        "Dimension mismatch",
    )
    _require(_size(vals) == math.prod(dims), "Dimension mismatch")
    _require(all(d >= min_size for d in dims), size_msg)
    steps_np = np.asarray(steps)  # (ndims,) — negligible transfer
    _require(bool(np.all(steps_np > 0)), "All grids must be monotonically increasing")
    n = _size(out)  # out is mandatory (dtype check already rejected None)
    _require(all(_size(x) == n for x in obs), "Dimension mismatch")


def _validate_rectilinear(grids, vals, obs, out, *, min_size, size_msg):
    ndims = len(grids)
    _require(len(obs) == ndims, "Dimension mismatch")
    dims = tuple(_size(g) for g in grids)
    _require(_size(vals) == math.prod(dims), "Dimension mismatch")
    _require(all(d >= min_size for d in dims), size_msg)
    for g in grids:
        g0, g1 = np.asarray(g[:2])  # first two entries only, as in the reference
        _require(g1 > g0, "All grids must be monotonically increasing")
    n = _size(out)  # out is mandatory (dtype check already rejected None)
    _require(all(_size(x) == n for x in obs), "Dimension mismatch")


def _raise_unrep(bad):
    if bool(bad):
        raise AssertionError("Unrepresentable coordinate value")


def _finish(result, out):
    """Write the device result into a preallocated numpy `out` (the
    reference's in-place contract) and return it. Device-array `out` is not
    writable; the computed array is returned instead."""
    if out is not None and isinstance(out, np.ndarray):
        np.copyto(out, np.asarray(result).reshape(out.shape))
        return out
    return result


def _to_dev(a, dtype):
    """Move one array to device at the requested dtype, without a host
    round-trip when it is already a JAX array."""
    if isinstance(a, jax.Array):
        return a.ravel() if a.dtype == dtype else a.astype(dtype).ravel()
    return jnp.asarray(np.asarray(a).ravel(), dtype=dtype)


def _host_small(out, n, *data):
    """True when this call should take the native CPU path: small batch,
    numpy (host) data, preallocated numpy out."""
    return (
        isinstance(out, np.ndarray)
        and native.use_native(n)
        and not any(isinstance(a, jax.Array) for a in data)
    )


def _vals_finite_host(dtype, vals) -> bool:
    """Host-side finiteness flag for the forced factorized engine (see
    ops.dispatch). The table is scanned only when that engine is forced,
    the one configuration that reads the flag."""
    if ops.dispatch.impl_mode() != "factorized":
        return True
    try:
        return bool(np.isfinite(np.asarray(vals)).all())
    except TypeError:
        return True


def _fresh_obs(obs) -> bool:
    """True when every obs array is host data: _prep_list will create fresh
    device buffers, which are then safe to donate to the kernel."""
    return not any(isinstance(a, jax.Array) for a in obs)


def _prep(dtype, *arrays):
    return tuple(_to_dev(a, dtype) for a in arrays)


def _prep_list(dtype, arrays):
    return tuple(_to_dev(a, dtype) for a in arrays)


# ---------------------------------------------------------------------------
# public shims
# ---------------------------------------------------------------------------


def _interpn_linear_regular(dtype, dims, starts, steps, vals, obs, out):
    _check_eval_dtypes(
        dtype, out, obs, [("starts", starts), ("steps", steps), ("vals", vals)]
    )
    dims = _as_dims(dims)
    _require(1 <= len(dims), "Dimension mismatch")
    _require(len(dims) <= 8, _MAX_DIMS_MSG)
    _validate_regular(
        dims, starts, steps, vals, obs, out,
        min_size=2, size_msg="All grids must have at least two entries",
    )
    if _host_small(out, _size(out), vals, *obs) and native.linear_regular(
        dims, starts, steps, vals, obs, out
    ):
        return out
    vf = _vals_finite_host(dtype, vals)
    core = _linear_regular_don if _fresh_obs(obs) else _linear_regular
    starts_j, steps_j, vals_j = _prep(dtype, starts, steps, vals)
    obs_j = _prep_list(dtype, obs)
    with _quiet_donation():
        result, bad = core(dims, starts_j, steps_j, vals_j, obs_j, vf)
    _raise_unrep(bad)
    return _finish(result, out)


def interpn_linear_regular_f64(dims, starts, steps, vals, obs, out):
    return _interpn_linear_regular(jnp.float64, dims, starts, steps, vals, obs, out)


def interpn_linear_regular_f32(dims, starts, steps, vals, obs, out):
    return _interpn_linear_regular(jnp.float32, dims, starts, steps, vals, obs, out)


def _interpn_linear_rectilinear(dtype, grids, vals, obs, out):
    _check_eval_dtypes(
        dtype, out, obs, [("grids", g) for g in grids] + [("vals", vals)]
    )
    _require(1 <= len(grids), "Dimension mismatch")
    _require(len(grids) <= 8, _MAX_DIMS_MSG)
    _validate_rectilinear(
        grids, vals, obs, out,
        min_size=2, size_msg="All grids must have at least 2 entries",
    )
    if _host_small(out, _size(out), vals, *obs) and native.linear_rectilinear(
        grids, vals, obs, out
    ):
        return out
    vf = _vals_finite_host(dtype, vals)
    core = _linear_rectilinear_don if _fresh_obs(obs) else _linear_rectilinear
    grids_j = _prep_list(dtype, grids)
    (vals_j,) = _prep(dtype, vals)
    obs_j = _prep_list(dtype, obs)
    with _quiet_donation():
        result = core(grids_j, vals_j, obs_j, vf)
    return _finish(result, out)


def interpn_linear_rectilinear_f64(grids, vals, obs, out):
    return _interpn_linear_rectilinear(jnp.float64, grids, vals, obs, out)


def interpn_linear_rectilinear_f32(grids, vals, obs, out):
    return _interpn_linear_rectilinear(jnp.float32, grids, vals, obs, out)


def _interpn_nearest_regular(dtype, dims, starts, steps, vals, obs, out):
    _check_eval_dtypes(
        dtype, out, obs, [("starts", starts), ("steps", steps), ("vals", vals)]
    )
    dims = _as_dims(dims)
    _require(1 <= len(dims), "Dimension mismatch")
    _require(len(dims) <= 6, "Dimension exceeds maximum (6).")
    _validate_regular(
        dims, starts, steps, vals, obs, out,
        min_size=2, size_msg="All grids must have at least two entries",
    )
    if _host_small(out, _size(out), vals, *obs) and native.nearest_regular(
        dims, starts, steps, vals, obs, out
    ):
        return out
    vf = _vals_finite_host(dtype, vals)
    core = _nearest_regular_don if _fresh_obs(obs) else _nearest_regular
    starts_j, steps_j, vals_j = _prep(dtype, starts, steps, vals)
    obs_j = _prep_list(dtype, obs)
    with _quiet_donation():
        result, bad = core(dims, starts_j, steps_j, vals_j, obs_j, vf)
    _raise_unrep(bad)
    return _finish(result, out)


def interpn_nearest_regular_f64(dims, starts, steps, vals, obs, out):
    return _interpn_nearest_regular(jnp.float64, dims, starts, steps, vals, obs, out)


def interpn_nearest_regular_f32(dims, starts, steps, vals, obs, out):
    return _interpn_nearest_regular(jnp.float32, dims, starts, steps, vals, obs, out)


def _interpn_nearest_rectilinear(dtype, grids, vals, obs, out):
    _check_eval_dtypes(
        dtype, out, obs, [("grids", g) for g in grids] + [("vals", vals)]
    )
    _require(1 <= len(grids), "Dimension mismatch")
    _require(len(grids) <= 6, "Dimension exceeds maximum (6).")
    _validate_rectilinear(
        grids, vals, obs, out,
        min_size=2, size_msg="All grids must have at least 2 entries",
    )
    if _host_small(out, _size(out), vals, *obs) and native.nearest_rectilinear(
        grids, vals, obs, out
    ):
        return out
    vf = _vals_finite_host(dtype, vals)
    core = _nearest_rectilinear_don if _fresh_obs(obs) else _nearest_rectilinear
    grids_j = _prep_list(dtype, grids)
    (vals_j,) = _prep(dtype, vals)
    obs_j = _prep_list(dtype, obs)
    with _quiet_donation():
        result = core(grids_j, vals_j, obs_j, vf)
    return _finish(result, out)


def interpn_nearest_rectilinear_f64(grids, vals, obs, out):
    return _interpn_nearest_rectilinear(jnp.float64, grids, vals, obs, out)


def interpn_nearest_rectilinear_f32(grids, vals, obs, out):
    return _interpn_nearest_rectilinear(jnp.float32, grids, vals, obs, out)


def _interpn_cubic_regular(
    dtype, dims, starts, steps, vals, linearize_extrapolation, obs, out
):
    _check_eval_dtypes(
        dtype, out, obs, [("starts", starts), ("steps", steps), ("vals", vals)]
    )
    dims = _as_dims(dims)
    _require(1 <= len(dims), "Dimension mismatch")
    _require(len(dims) <= 8, _MAX_DIMS_MSG)
    _validate_regular(
        dims, starts, steps, vals, obs, out,
        min_size=4, size_msg="All grids must have at least four entries",
    )
    if _host_small(out, _size(out), vals, *obs) and native.cubic_regular(
        dims, starts, steps, vals, bool(linearize_extrapolation), obs, out
    ):
        return out
    vf = _vals_finite_host(dtype, vals)
    core = _cubic_regular_don if _fresh_obs(obs) else _cubic_regular
    starts_j, steps_j, vals_j = _prep(dtype, starts, steps, vals)
    obs_j = _prep_list(dtype, obs)
    with _quiet_donation():
        result, bad = core(
            dims, starts_j, steps_j, vals_j, obs_j,
            bool(linearize_extrapolation), vf,
        )
    _raise_unrep(bad)
    return _finish(result, out)


def interpn_cubic_regular_f64(dims, starts, steps, vals, linearize_extrapolation, obs, out):
    return _interpn_cubic_regular(
        jnp.float64, dims, starts, steps, vals, linearize_extrapolation, obs, out
    )


def interpn_cubic_regular_f32(dims, starts, steps, vals, linearize_extrapolation, obs, out):
    return _interpn_cubic_regular(
        jnp.float32, dims, starts, steps, vals, linearize_extrapolation, obs, out
    )


def _interpn_cubic_rectilinear(dtype, grids, vals, linearize_extrapolation, obs, out):
    _check_eval_dtypes(
        dtype, out, obs, [("grids", g) for g in grids] + [("vals", vals)]
    )
    _require(1 <= len(grids), "Dimension mismatch")
    _require(len(grids) <= 8, _MAX_DIMS_MSG)
    _validate_rectilinear(
        grids, vals, obs, out,
        min_size=4, size_msg="All grids must have at least 4 entries",
    )
    if _host_small(out, _size(out), vals, *obs) and native.cubic_rectilinear(
        grids, vals, bool(linearize_extrapolation), obs, out
    ):
        return out
    vf = _vals_finite_host(dtype, vals)
    core = _cubic_rectilinear_don if _fresh_obs(obs) else _cubic_rectilinear
    grids_j = _prep_list(dtype, grids)
    (vals_j,) = _prep(dtype, vals)
    obs_j = _prep_list(dtype, obs)
    with _quiet_donation():
        result = core(
            grids_j, vals_j, obs_j, bool(linearize_extrapolation), vf
        )
    return _finish(result, out)


def interpn_cubic_rectilinear_f64(grids, vals, linearize_extrapolation, obs, out):
    return _interpn_cubic_rectilinear(
        jnp.float64, grids, vals, linearize_extrapolation, obs, out
    )


def interpn_cubic_rectilinear_f32(grids, vals, linearize_extrapolation, obs, out):
    return _interpn_cubic_rectilinear(
        jnp.float32, grids, vals, linearize_extrapolation, obs, out
    )


def _check_bounds_regular_host(dtype, dims, starts, steps, obs, atol, out):
    _check_bounds_dtypes(dtype, out, obs, [("starts", starts), ("steps", steps)])
    dims = _as_dims(dims)
    ndims = len(dims)
    _require(
        len(obs) == ndims and np.asarray(out).size == ndims,
        "Dimension mismatch",
    )
    if (
        isinstance(out, np.ndarray)
        and native.use_native(_size(obs[0]))
        and not any(isinstance(a, jax.Array) for a in obs)
        and native.check_bounds_regular(
            dims, starts, steps, obs, atol, out,
            np.float64 if dtype == jnp.float64 else np.float32,
        )
    ):
        return out
    starts_j, steps_j = _prep(dtype, starts, steps)
    obs_j = _prep_list(dtype, obs)
    atol_j = jnp.asarray(atol, dtype=dtype)
    return _finish(_check_bounds_regular(dims, starts_j, steps_j, obs_j, atol_j), out)


def check_bounds_regular_f64(dims, starts, steps, obs, atol, out):
    return _check_bounds_regular_host(jnp.float64, dims, starts, steps, obs, atol, out)


def check_bounds_regular_f32(dims, starts, steps, obs, atol, out):
    return _check_bounds_regular_host(jnp.float32, dims, starts, steps, obs, atol, out)


def _check_bounds_rectilinear_host(dtype, grids, obs, atol, out):
    _check_bounds_dtypes(dtype, out, obs, [("grids", g) for g in grids])
    ndims = len(grids)
    _require(
        len(obs) == ndims and np.asarray(out).size == ndims,
        "Dimension mismatch",
    )
    _require(all(np.asarray(g).size > 0 for g in grids), "Dimension mismatch")
    if (
        isinstance(out, np.ndarray)
        and native.use_native(_size(obs[0]))
        and not any(isinstance(a, jax.Array) for a in obs)
        and native.check_bounds_rectilinear(
            grids, obs, atol, out,
            np.float64 if dtype == jnp.float64 else np.float32,
        )
    ):
        return out
    grids_j = _prep_list(dtype, grids)
    obs_j = _prep_list(dtype, obs)
    atol_j = jnp.asarray(atol, dtype=dtype)
    return _finish(_check_bounds_rectilinear(grids_j, obs_j, atol_j), out)


def check_bounds_rectilinear_f64(grids, obs, atol, out):
    return _check_bounds_rectilinear_host(jnp.float64, grids, obs, atol, out)


def check_bounds_rectilinear_f32(grids, obs, atol, out):
    return _check_bounds_rectilinear_host(jnp.float32, grids, obs, atol, out)
