"""interpn-tpu: N-dimensional grid interpolation in JAX.

A from-scratch JAX/XLA re-design of the capabilities of jlogan03/interpn
(multilinear / multicubic / nearest interpolation and extrapolation on regular
and rectilinear grids) with the same Python API surface:

* `interpn(...)` one-shot convenience function
  (reference: `src/interpn/__init__.py:48-203`)
* `interpn_tpu.raw` — the 16 flat monomorphized functions
* Six persistent pydantic interpolator classes with byte-identical JSON
  serialization
* `interpn_tpu.ops` — the batched functional kernels (jit/vmap/shard-able)
* `interpn_tpu.ops.one_dim` — the 1D fast-path interpolants
* `interpn_tpu.parallel` — device-mesh sharding over the observation axis
"""

from __future__ import annotations

from typing import Literal, Sequence

import numpy as np
from numpy.typing import NDArray

from importlib.util import find_spec as _find_spec

from . import config as _config  # noqa: F401  (enables x64 before any jax use)
from . import raw

# The persistent model classes need pydantic; like the reference
# (`src/interpn/__init__.py:19-27`), the functional API works without it.
_PYDANTIC_FOUND = _find_spec("pydantic") is not None

if _PYDANTIC_FOUND:
    from .models import (
        MulticubicRectilinear,
        MulticubicRegular,
        MultilinearRectilinear,
        MultilinearRegular,
        NearestRectilinear,
        NearestRegular,
        TensorSplineRectilinear,
        TensorSplineRegular,
    )

__version__ = "0.4.0"

__all__ = [
    "__version__",
    "raw",
    "interpn",
    "interpn_stack",
]

if _PYDANTIC_FOUND:
    __all__ += [
        "MultilinearRegular",
        "MultilinearRectilinear",
        "MulticubicRegular",
        "MulticubicRectilinear",
        "NearestRegular",
        "NearestRectilinear",
        "TensorSplineRegular",
        "TensorSplineRectilinear",
    ]


def interpn(
    obs: Sequence[NDArray],
    grids: Sequence[NDArray],
    vals: NDArray,
    *,
    method: Literal[
        "linear", "cubic", "nearest", "pchip", "cubic_spline", "quintic"
    ] = "linear",
    out: NDArray | None = None,
    linearize_extrapolation: bool = True,
    assume_regular: bool = False,
    check_bounds: bool = False,
    bounds_atol: float = 1e-8,
) -> NDArray:
    """Evaluate an N-dimensional grid at the supplied observation points.

    Behavioral parity with the reference one-shot helper
    (`src/interpn/__init__.py:48-203`): grid-regularity autodetection (exact
    spacing equality, `:197-203`), optional bounds checking that raises
    ValueError (`:114-132`), and dispatch on (dtype, regularity, method).

    Args:
        obs: Observation coordinates, one array per dimension.
        grids: Grid axis coordinates, one array per dimension.
        vals: Values defined on the full tensor-product grid (C order).
        method: "linear", "cubic", "nearest" (reference parity), or one of
            the extensions with no reference analogue: "pchip"
            (monotone cubic, scipy-pchip semantics, >= 4 points per axis),
            "cubic_spline" / "quintic" (global not-a-knot tensor-product
            splines of degree 3/5, scipy RGI cubic/quintic semantics,
            >= 4/6 points per axis — `ops.bspline`, coefficients solved
            exactly on the host per call). The extensions ignore
            `linearize_extrapolation`.
        out: Optional preallocated output array.
        linearize_extrapolation: Cubic extrapolation falls back to linear.
        assume_regular: Skip the O(gridsize) regularity check.
        check_bounds: Raise ValueError if any observation is out of bounds.
        bounds_atol: Absolute tolerance for the bounds check.

    Returns:
        Interpolated values, shaped like `out` (or obs[0]).
    """
    user_out = out if out is not None else np.zeros_like(obs[0])
    outshape = user_out.shape
    out = user_out.ravel()
    # ravel() of a non-contiguous array returns a COPY; the reference
    # silently decouples from the caller's buffer in that case. Keep the
    # in-place contract instead: compute into the flat view/copy, then fold
    # results back into the caller's array before returning it.
    out_is_view = out.base is not None or out is user_out

    obs = [np.ascontiguousarray(np.asarray(x).ravel()) for x in obs]
    grids = [np.ascontiguousarray(np.asarray(x).ravel()) for x in grids]
    vals = np.ascontiguousarray(np.asarray(vals).ravel())

    dtype = vals.dtype
    assert dtype in [np.float64, np.float32], (
        "`interpn` defined only for float32 and float64 data"
    )

    is_regular = assume_regular or _check_regular(grids)

    if is_regular:
        dims = np.array([len(grid) for grid in grids], dtype=int)
        starts = np.array([grid[0] for grid in grids], dtype=dtype)
        steps = np.array([grid[1] - grid[0] for grid in grids], dtype=dtype)
    else:
        dims = np.empty((0,), dtype=int)
        starts = np.empty((0,), dtype=dtype)
        steps = starts

    if check_bounds:
        ndims = len(grids)
        outb = np.zeros((ndims,), dtype=bool)
        match (dtype, is_regular):
            case (np.float32, True):
                raw.check_bounds_regular_f32(dims, starts, steps, obs, bounds_atol, outb)
            case (np.float64, True):
                raw.check_bounds_regular_f64(dims, starts, steps, obs, bounds_atol, outb)
            case (np.float32, False):
                raw.check_bounds_rectilinear_f32(grids, obs, bounds_atol, outb)
            case (np.float64, False):
                raw.check_bounds_rectilinear_f64(grids, obs, bounds_atol, outb)
        if any(outb):
            raise ValueError("Observation points violate interpolator bounds")

    if method == "pchip":
        # extension (no reference analogue): monotone cubic with
        # scipy-pchip semantics, held to the same input contracts as the
        # reference methods (raw-layer validators + dtype strictness).
        from .ops import pchip as _pchip

        if is_regular:
            arrays = [("starts", starts), ("steps", steps), ("vals", vals)]
        else:
            arrays = [(f"grids[{k}]", g) for k, g in enumerate(grids)]
            arrays.append(("vals", vals))
        raw._check_eval_dtypes(dtype, out, obs, arrays)
        if is_regular:
            dims_t = tuple(int(d) for d in dims)
            raw._validate_regular(
                dims_t, starts, steps, vals, obs, out,
                min_size=4, size_msg="All grids must have at least four entries",
            )
            res = _pchip.jitted("regular")(dims_t, starts, steps, vals, obs)
        else:
            raw._validate_rectilinear(
                grids, vals, obs, out,
                min_size=4, size_msg="All grids must have at least 4 entries",
            )
            res = _pchip.jitted("rectilinear")(grids, vals, obs)
        np.copyto(out, np.asarray(res))
        if not out_is_view:
            np.copyto(user_out, out.reshape(outshape))
            return user_out
        return out.reshape(outshape)

    if method in ("cubic_spline", "quintic"):
        # extension (no reference analogue): global not-a-knot
        # tensor-product splines with scipy RGI cubic/quintic semantics.
        # Coefficients are solved exactly on the host (tables are concrete
        # by the raw-layer contract); evaluation runs in the table dtype.
        from .ops import bspline as _bspline

        k = 3 if method == "cubic_spline" else 5
        arrays = [(f"grids[{i}]", g) for i, g in enumerate(grids)]
        arrays.append(("vals", vals))
        raw._check_eval_dtypes(dtype, out, obs, arrays)
        raw._validate_rectilinear(
            grids, vals, obs, out,
            min_size=k + 1,
            size_msg=f"All grids must have at least {k + 1} entries",
        )
        knots, coeffs = _bspline.prep_bspline_cached(
            grids, vals.astype(np.float64, copy=False), k
        )
        knots = [t.astype(dtype, copy=False) for t in knots]
        res = _bspline.jitted_eval()(knots, coeffs.astype(dtype, copy=False), obs, k)
        np.copyto(out, np.asarray(res))
        if not out_is_view:
            np.copyto(user_out, out.reshape(outshape))
            return user_out
        return out.reshape(outshape)

    match (dtype, is_regular, method):
        case (np.float32, True, "linear"):
            raw.interpn_linear_regular_f32(dims, starts, steps, vals, obs, out)
        case (np.float64, True, "linear"):
            raw.interpn_linear_regular_f64(dims, starts, steps, vals, obs, out)
        case (np.float32, False, "linear"):
            raw.interpn_linear_rectilinear_f32(grids, vals, obs, out)
        case (np.float64, False, "linear"):
            raw.interpn_linear_rectilinear_f64(grids, vals, obs, out)
        case (np.float32, True, "nearest"):
            raw.interpn_nearest_regular_f32(dims, starts, steps, vals, obs, out)
        case (np.float64, True, "nearest"):
            raw.interpn_nearest_regular_f64(dims, starts, steps, vals, obs, out)
        case (np.float32, False, "nearest"):
            raw.interpn_nearest_rectilinear_f32(grids, vals, obs, out)
        case (np.float64, False, "nearest"):
            raw.interpn_nearest_rectilinear_f64(grids, vals, obs, out)
        case (np.float32, True, "cubic"):
            raw.interpn_cubic_regular_f32(
                dims, starts, steps, vals, linearize_extrapolation, obs, out
            )
        case (np.float64, True, "cubic"):
            raw.interpn_cubic_regular_f64(
                dims, starts, steps, vals, linearize_extrapolation, obs, out
            )
        case (np.float32, False, "cubic"):
            raw.interpn_cubic_rectilinear_f32(
                grids, vals, linearize_extrapolation, obs, out
            )
        case (np.float64, False, "cubic"):
            raw.interpn_cubic_rectilinear_f64(
                grids, vals, linearize_extrapolation, obs, out
            )
        case _:
            raise ValueError(
                "Unsupported interpolation configuration:"
                f" {dtype}, {is_regular}, {method}"
            )

    if not out_is_view:
        np.copyto(user_out, out.reshape(outshape))
        return user_out
    return out.reshape(outshape)


def interpn_stack(
    obs: Sequence[NDArray],
    grids: Sequence[NDArray],
    vals: NDArray,
    *,
    method: Literal[
        "linear", "cubic", "nearest", "pchip", "cubic_spline", "quintic"
    ] = "linear",
    linearize_extrapolation: bool = True,
    assume_regular: bool = False,
    check_bounds: bool = False,
    bounds_atol: float = 1e-8,
) -> NDArray:
    """Evaluate a STACK of value tables sharing one grid at the same points.

    Extension with no reference analogue (the reference binds one table per
    interpolator, `src/interpn/multilinear_regular.py:24-212`). `vals`
    carries the channel axis first — shape (nch, *grid_shape) or
    (nch, prod(dims)) — and the result is (nch, *obs_shape). Channels batch
    through `jax.vmap` over one device program.

    Args other than `vals` match `interpn` (no `out=`: the result is a new
    (nch, ...) array).
    """
    from . import ops as _ops

    obs_np = [np.ascontiguousarray(np.asarray(x)) for x in obs]
    outshape = obs_np[0].shape
    obs_np = [x.ravel() for x in obs_np]
    grids = [np.ascontiguousarray(np.asarray(g).ravel()) for g in grids]
    vals = np.ascontiguousarray(np.asarray(vals))
    if vals.ndim < 2:
        raise AssertionError("Dimension mismatch")
    nch = vals.shape[0]
    vals2 = vals.reshape(nch, -1)

    dtype = vals2.dtype
    assert dtype in [np.float64, np.float32], (
        "`interpn` defined only for float32 and float64 data"
    )
    for x in obs_np + grids:
        if x.dtype != dtype:
            raise TypeError(
                "All arrays must share one float dtype (np.float32 or"
                " np.float64)"
            )

    ndims = len(grids)
    if len(obs_np) != ndims:
        raise AssertionError("Dimension mismatch")
    expected = 1
    for g in grids:
        expected *= len(g)
    if vals2.shape[1] != expected:
        raise AssertionError("Size of value array does not match grid dims")

    is_regular = assume_regular or _check_regular(grids)
    dims = tuple(len(g) for g in grids)
    if check_bounds:
        outb = np.zeros((ndims,), dtype=bool)
        starts_np = np.array([g[0] for g in grids], dtype=dtype)
        steps_np = np.array([g[1] - g[0] for g in grids], dtype=dtype)
        match (dtype, is_regular):
            case (np.float32, True):
                raw.check_bounds_regular_f32(
                    np.array(dims), starts_np, steps_np, obs_np, bounds_atol, outb
                )
            case (np.float64, True):
                raw.check_bounds_regular_f64(
                    np.array(dims), starts_np, steps_np, obs_np, bounds_atol, outb
                )
            case (np.float32, False):
                raw.check_bounds_rectilinear_f32(grids, obs_np, bounds_atol, outb)
            case (np.float64, False):
                raw.check_bounds_rectilinear_f64(grids, obs_np, bounds_atol, outb)
        if any(outb):
            raise ValueError("Observation points violate interpolator bounds")

    import jax.numpy as jnp

    obs_j = tuple(jnp.asarray(x) for x in obs_np)

    if method in ("pchip", "cubic_spline", "quintic"):
        # extension channels: shared grid geometry, one prep, channels
        # mapped on device (pchip is nonlinear per channel; the splines
        # share knots and vmap over the coefficient tables)
        import jax

        if method == "pchip":
            from .ops import pchip as _pchip

            floor_msg = "All grids must have at least 4 entries"
            if any(len(g) < 4 for g in grids):
                raise AssertionError(floor_msg)
            if is_regular:
                dims_t = tuple(int(d) for d in dims)
                starts_j = jnp.asarray(
                    np.array([g[0] for g in grids], dtype=dtype)
                )
                steps_j = jnp.asarray(
                    np.array([g[1] - g[0] for g in grids], dtype=dtype)
                )
                f = lambda v: _pchip.pchip_regular(
                    dims_t, starts_j, steps_j, v, obs_j
                )
            else:
                grids_j = tuple(jnp.asarray(g) for g in grids)
                f = lambda v: _pchip.pchip_rectilinear(grids_j, v, obs_j)
            out = jax.vmap(f)(jnp.asarray(vals2))
        else:
            from .ops import bspline as _bspline

            k = 3 if method == "cubic_spline" else 5
            if any(len(g) < k + 1 for g in grids):
                raise AssertionError(
                    f"All grids must have at least {k + 1} entries"
                )
            knots, coeffs = _bspline.prep_bspline_cached(
                grids, np.ascontiguousarray(vals2.T, dtype=np.float64), k
            )
            knots_j = [jnp.asarray(t.astype(dtype, copy=False)) for t in knots]
            ct = jnp.asarray(
                np.ascontiguousarray(coeffs.T).astype(dtype, copy=False)
            )
            out = _bspline.bspline_eval_stack(tuple(knots_j), ct, obs_j, k)
        return np.asarray(out, dtype=dtype).reshape((nch,) + outshape)

    vals_j = jnp.asarray(vals2)
    vf = raw._vals_finite_host(dtype, vals2)
    if is_regular:
        starts = jnp.asarray(np.array([g[0] for g in grids], dtype=dtype))
        steps = jnp.asarray(np.array([g[1] - g[0] for g in grids], dtype=dtype))
        match method:
            case "linear":
                out = _ops.linear_regular_stack(
                    dims, starts, steps, vals_j, obs_j, vals_finite=vf
                )
            case "nearest":
                out = _ops.nearest_regular_stack(
                    dims, starts, steps, vals_j, obs_j, vals_finite=vf
                )
            case "cubic":
                out = _ops.cubic_regular_stack(
                    dims, starts, steps, vals_j, obs_j,
                    linearize_extrapolation, vals_finite=vf,
                )
            case _:
                raise ValueError(f"Unsupported method: {method}")
    else:
        grids_j = tuple(jnp.asarray(g) for g in grids)
        match method:
            case "linear":
                out = _ops.linear_rectilinear_stack(
                    grids_j, vals_j, obs_j, vals_finite=vf
                )
            case "nearest":
                out = _ops.nearest_rectilinear_stack(
                    grids_j, vals_j, obs_j, vals_finite=vf
                )
            case "cubic":
                out = _ops.cubic_rectilinear_stack(
                    grids_j, vals_j, obs_j, linearize_extrapolation,
                    vals_finite=vf,
                )
            case _:
                raise ValueError(f"Unsupported method: {method}")
    return np.asarray(out, dtype=dtype).reshape((nch,) + outshape)


def _check_regular(grids: Sequence[NDArray]) -> bool:
    """Check if grids are all regularly spaced (exact equality of spacings,
    matching the reference `_check_regular`, `__init__.py:197-203`)."""
    is_regular = True
    for grid in grids:
        dgrid = np.diff(grid)
        is_regular = is_regular and bool(np.all(dgrid == dgrid[0]))
    return bool(is_regular)
