"""scipy.interpolate-compatible adapter layer.

Drop-in equivalents of ``scipy.interpolate.RegularGridInterpolator`` and
``scipy.interpolate.interpn`` backed by this package's device engines.
The reference library positions itself against scipy's RGI (its benchmark
suite normalizes every number to scipy RGI throughput,
``/root/reference/benches/bench_cpu.py:516-523``); this module lets scipy
users migrate without rewriting call sites.

API semantics mirrored from scipy 1.17 (probed, not copied):

* ``points`` axes may be strictly ascending or descending; descending axes
  are flipped internally and ``.grid`` stores the ascending copy.
* ``values`` may carry trailing (non-grid) axes; those evaluate as a
  channel stack through :func:`interpn_tpu.interpn_stack` and appear as
  trailing axes of the result.
* ``xi`` accepts an ``(..., ndim)`` array, a broadcastable tuple of
  coordinate arrays, or a 1-D array (a column of points for 1-D grids, a
  single point otherwise).
* ``bounds_error`` / ``fill_value`` / NaN semantics match scipy exactly:
  exact ``lo <= x <= hi`` bounds test, NaN coordinates raise when
  ``bounds_error`` else produce NaN output (never ``fill_value``), and
  ``fill_value=None`` extrapolates.
* Error messages match scipy's strings.

Every scipy RGI method is supported: ``linear``, ``nearest``, ``slinear``,
``cubic``, ``quintic``, and ``pchip``.

* A degree-1 tensor spline is the same piecewise-linear function
  multilinear interpolation evaluates (probed: scipy's two methods agree
  to 1 ulp), so ``slinear`` routes to the linear engine.
* ``cubic`` / ``quintic`` are the global not-a-knot tensor-product splines
  (:mod:`interpn_tpu.ops.bspline`).  The coefficients come from exact
  per-axis direct solves, so this adapter matches the mathematical
  interpolant (scipy's own recursive 1-d ``make_interp_spline`` definition)
  to ~1e-14 — scipy 1.17's RGI solves the N-d collocation system with an
  iterative solver (``gcrotmk``) and deviates from its own definition by
  up to ~1e-4 in 3D (and can fail to converge outright, raising
  ``ValueError: solver ... returns info = 1000``); agreement with scipy
  RGI output is therefore bounded by scipy's solver tolerance, not ours.
* ``pchip`` runs this package's monotone-cubic gather engine
  (:mod:`interpn_tpu.ops.pchip`, scipy-matched slopes/recursion order,
  agreement ~1e-13).

Deliberate deviations (documented, not accidental):

* Extension method ``hermite``: the reference library's local cubic
  Hermite scheme (centered differences, natural boundary,
  ``src/multicubic/mod.rs:68-117``) — scipy has no equivalent.  The
  ``linearize_extrapolation`` extension kwarg applies to this method only
  (it selects the reference's linearized out-of-bounds mode,
  ``src/multicubic/regular.rs:553-561``) and is ignored by the spline
  methods.
* Nearest midpoint tie-breaking follows the reference (``dt <= 0.5`` takes
  the lower node, ``src/nearest/regular.rs:283-287``); scipy documents its
  own tie behavior as unspecified.
* NaN coordinates always produce NaN output (scipy's documented rule).
  scipy's own ND ``pchip`` implementation instead RAISES on a NaN
  coordinate when ``ndim >= 2`` (the NaN poisons the next axis's 1-d fit
  data: ``ValueError: `y` must contain only finite values``); this
  adapter applies the documented rule uniformly.
* Complex values are unsupported.

Computation runs in float64 by default (matching scipy's promotion — a
float32 ``values`` array still yields float64 output).  Pass
``dtype=np.float32`` (an extension kwarg; scipy has none) to opt into
float32: everything — grids, values, queries — is cast to float32 and
evaluation rides the same device engines as the native API, at float32
accuracy (~1e-6 relative instead of ~1e-15).  The global spline methods
still run their collocation *fit* in float64 and cast the coefficients,
so the f32 error is evaluation-only.
"""

from __future__ import annotations

import numpy as np

__all__ = ["RegularGridInterpolator", "interpn"]

_METHODS = ("linear", "nearest", "cubic", "slinear", "pchip", "quintic", "hermite")
_SPLINE_DEGREE = {"cubic": 3, "quintic": 5}

def _pchip_core():
    """The shared jitted pchip evaluator (jax caches per grid/batch shape
    under it, so repeat calls don't retrace)."""
    from .ops import pchip

    return pchip.jitted("rectilinear")


def _bspline_core():
    """The shared jitted B-spline evaluator (degree is a static arg)."""
    from .ops import bspline

    return bspline.jitted_eval()


def _resolve_dtype(dtype):
    """Normalize the compat layer's dtype opt-in: None -> float64 (scipy
    promotion), else float32/float64 only."""
    if dtype is None:
        return np.dtype(np.float64)
    dt = np.dtype(dtype)
    if dt not in (np.dtype(np.float32), np.dtype(np.float64)):
        raise ValueError(
            "dtype must be None (float64, scipy-compatible), float32, or "
            f"float64; got {dt}"
        )
    return dt


def _as_points(points, values, dtype=np.float64):
    """Validate grid axes, flip descending ones, return (grids, values)."""
    if hasattr(values, "ndim") and np.iscomplexobj(values):
        raise ValueError("complex values are not supported by interpn_tpu.compat")
    values = np.asarray(values, dtype=dtype)
    if isinstance(points, np.ndarray) and points.ndim == 1:
        points = (points,)
    grids = []
    for i, p in enumerate(points):
        p = np.ascontiguousarray(np.asarray(p, dtype=dtype))
        if p.ndim != 1:
            raise ValueError(f"The points in dimension {i} must be 1-dimensional")
        d = np.diff(p)
        if np.all(d > 0):
            pass
        elif np.all(d < 0):
            p = p[::-1].copy()
            values = np.flip(values, axis=i)
        else:
            raise ValueError(
                f"The points in dimension {i} must be strictly "
                "ascending or descending"
            )
        grids.append(p)
    if values.ndim < len(grids):
        raise ValueError(
            f"There are {len(grids)} point arrays, but values has "
            f"{values.ndim} dimensions"
        )
    for i, g in enumerate(grids):
        if values.shape[i] != g.size:
            raise ValueError(
                f"There are {g.size} points and {values.shape[i]} values "
                f"in dimension {i}"
            )
    return grids, np.ascontiguousarray(values)


def _check_method(method, grids, values):
    if method not in _METHODS:
        raise ValueError(f"Method '{method}' is not defined")
    min_pts = {
        "cubic": 4, "slinear": 2, "pchip": 4, "quintic": 6, "hermite": 4
    }.get(method)
    if min_pts is not None:
        for i, g in enumerate(grids):
            if g.size < min_pts:
                # scipy's message (double space included)
                raise ValueError(
                    f"There are {g.size} points in dimension {i}, but "
                    f"method {method} requires at least  {min_pts} points "
                    "per dimension."
                )


class RegularGridInterpolator:
    """scipy-compatible interpolator over a rectilinear grid.

    Parameters, attributes (``grid``, ``values``, ``method``,
    ``bounds_error``, ``fill_value``), call convention, and error strings
    follow ``scipy.interpolate.RegularGridInterpolator``; evaluation runs
    on this package's engines (XLA on the device, C++ or XLA on the host).

    Extension method ``hermite`` selects the reference library's local
    cubic Hermite scheme; the ``linearize_extrapolation`` kwarg (default
    False) applies to it and switches out-of-bounds evaluation to the
    reference's linearized mode (``src/multicubic/regular.rs:553-561``).

    Extension kwarg ``dtype`` (default None -> float64, scipy's promotion
    rule): pass ``np.float32`` to run grids, values, queries, and output
    in float32 on the device engines.
    The spline methods' collocation fit stays float64; only evaluation is
    cast.  Output dtype follows the choice.
    """

    def __init__(
        self,
        points,
        values,
        method: str = "linear",
        bounds_error: bool = True,
        fill_value=np.nan,
        *,
        linearize_extrapolation: bool = False,
        dtype=None,
    ):
        self._dtype = _resolve_dtype(dtype)
        grids, values = _as_points(points, values, self._dtype)
        _check_method(method, grids, values)
        if linearize_extrapolation and method != "hermite":
            # the kwarg selects the reference Hermite scheme's linearized
            # out-of-bounds mode and has no effect on any other method —
            # make migrated callers notice instead of silently ignoring it
            import warnings

            warnings.warn(
                "linearize_extrapolation applies only to method='hermite' "
                f"(the reference library's local cubic); it is ignored by "
                f"method='{method}'",
                UserWarning,
                stacklevel=2,
            )
        if fill_value is not None:
            try:
                fill_value = float(fill_value)
            except (TypeError, ValueError):
                raise ValueError(
                    "fill_value must be either 'None' or of a type "
                    "compatible with values"
                ) from None
        self.grid = tuple(grids)
        self.values = values
        self.method = method
        self.bounds_error = bounds_error
        self.fill_value = fill_value
        self.linearize_extrapolation = linearize_extrapolation
        self._ndim = len(grids)
        self._models: dict[str, object] = {}
        # per-degree (knots, coefficients) for the global spline methods;
        # the collocation solves run once per (table, degree)
        self._splines: dict[int, tuple] = {}
        # scipy stores which input axes arrived descending; we re-derive
        # nothing from it, but the attribute name is part of the probed
        # public surface some callers touch.
        self._descending_dimensions = ()

    # -- xi marshalling ------------------------------------------------
    def _prepare_xi(self, xi):
        ndim = self._ndim
        if isinstance(xi, tuple):
            arrs = np.broadcast_arrays(
                *(np.asarray(a, dtype=self._dtype) for a in xi)
            )
            if len(arrs) != ndim:
                raise ValueError(
                    f"The requested sample points xi have dimension "
                    f"{len(arrs)} but this RegularGridInterpolator has "
                    f"dimension {ndim}"
                )
            xi = np.stack(arrs, axis=-1)
        else:
            xi = np.asarray(xi, dtype=self._dtype)
            if xi.ndim == 1:
                xi = xi.reshape(-1, 1) if ndim == 1 else xi.reshape(1, -1)
        if xi.ndim == 0 or xi.shape[-1] != ndim:
            have = xi.shape[-1] if xi.ndim else 0
            raise ValueError(
                f"The requested sample points xi have dimension {have} "
                f"but this RegularGridInterpolator has dimension {ndim}"
            )
        out_shape = xi.shape[:-1]
        flat = np.ascontiguousarray(xi.reshape(-1, ndim))
        return flat, out_shape

    # -- model cache ---------------------------------------------------
    def _model(self, method):
        m = self._models.get(method)
        if m is None:
            from . import (
                MulticubicRectilinear,
                MultilinearRectilinear,
                NearestRectilinear,
            )

            vals = self.values.reshape(-1)
            grids = list(self.grid)
            if method == "linear":
                m = MultilinearRectilinear.new(grids, vals)
            elif method == "hermite":
                m = MulticubicRectilinear.new(
                    grids, vals, linearize_extrapolation=self.linearize_extrapolation
                )
            else:
                m = NearestRectilinear.new(grids, vals)
            self._models[method] = m
        return m

    def _spline(self, k):
        """Cached (knots, flat coefficients with a trailing channel axis)
        for degree-k tensor-product spline evaluation."""
        sp = self._splines.get(k)
        if sp is None:
            from .ops import bspline

            ndim = self._ndim
            vt = self.values.reshape(
                int(np.prod(self.values.shape[:ndim])), -1
            )
            sp = bspline.prep_bspline(list(self.grid), vt, k)
            if self._dtype == np.float32:
                # fit ran float64 (prep_bspline casts internally); cast only
                # the evaluation-side arrays so the f32 error is eval-only
                # and the evaluation runs on f32 coefficients
                knots, coeffs = sp
                sp = (
                    [np.asarray(t, dtype=np.float32) for t in knots],
                    np.asarray(coeffs, dtype=np.float32),
                )
            self._splines[k] = sp
        return sp

    # -- evaluation ----------------------------------------------------
    def __call__(self, xi, method: str | None = None):
        method = self.method if method is None else method
        _check_method(method, self.grid, self.values)
        # a degree-1 tensor spline IS multilinear interpolation (same
        # piecewise-linear function; scipy's two methods agree to 1 ulp)
        if method == "slinear":
            method = "linear"
        flat, out_shape = self._prepare_xi(xi)
        ndim = self._ndim

        nan_mask = np.zeros(flat.shape[0], dtype=bool)
        oob_mask = np.zeros(flat.shape[0], dtype=bool)
        for i in range(ndim):
            p = flat[:, i]
            lo, hi = self.grid[i][0], self.grid[i][-1]
            bad = np.isnan(p)
            nan_mask |= bad
            if self.bounds_error:
                ok = np.logical_and(p >= lo, p <= hi)
                if not np.all(ok):
                    raise ValueError(
                        "One of the requested xi is out of bounds "
                        f"in dimension {i}"
                    )
            else:
                # exact scipy rule: NaN is *not* out-of-bounds (it gets
                # NaN output, never fill_value)
                oob_mask |= (p < lo) | (p > hi)

        sanitize = nan_mask if self.fill_value is None else (nan_mask | oob_mask)
        if sanitize.any():
            flat = flat.copy()
            for i in range(ndim):
                flat[sanitize, i] = self.grid[i][0]

        obs = [np.ascontiguousarray(flat[:, i]) for i in range(ndim)]
        trailing = self.values.shape[ndim:]
        if method in ("pchip", "cubic", "quintic"):
            # no pydantic model for these (no reference analogue); evaluate
            # through the ops engines directly, channels looped
            vt = self.values.reshape(np.prod(self.values.shape[:ndim]), -1)
            if method == "pchip":
                cols = [
                    np.asarray(_pchip_core()(list(self.grid), vt[:, c], obs))
                    for c in range(vt.shape[1])
                ]
            else:
                k = _SPLINE_DEGREE[method]
                knots, coeffs = self._spline(k)
                core = _bspline_core()
                cols = [
                    np.asarray(
                        core(knots, np.ascontiguousarray(coeffs[:, c]), obs, k)
                    )
                    for c in range(coeffs.shape[1])
                ]
            res = np.stack(cols, axis=0)  # (nch, npts)
            if self.fill_value is not None and oob_mask.any():
                res[:, oob_mask] = self.fill_value
            if nan_mask.any():
                res[:, nan_mask] = np.nan
            if trailing:
                return res.T.reshape(out_shape + trailing)
            return res[0].reshape(out_shape)
        if trailing:
            from . import interpn_stack

            nch = int(np.prod(trailing))
            # channel axis first: (nch, prod(grid))
            vt = np.ascontiguousarray(
                self.values.reshape(-1, nch).T
            )
            res = interpn_stack(
                obs,
                list(self.grid),
                vt,
                # the stack engine's "cubic" is the reference Hermite scheme
                method="cubic" if method == "hermite" else method,
                linearize_extrapolation=self.linearize_extrapolation,
            )
            res = np.array(res)  # (nch, npts); copy — jax buffers are read-only
            if self.fill_value is not None and oob_mask.any():
                res[:, oob_mask] = self.fill_value
            if nan_mask.any():
                res[:, nan_mask] = np.nan
            res = res.T.reshape(out_shape + trailing)
            return res

        res = self._model(method).eval(obs)
        if self.fill_value is not None and oob_mask.any():
            res[oob_mask] = self.fill_value
        if nan_mask.any():
            res[nan_mask] = np.nan
        return res.reshape(out_shape)


def interpn(
    points,
    values,
    xi,
    method: str = "linear",
    bounds_error: bool = True,
    fill_value=np.nan,
    *,
    dtype=None,
):
    """scipy.interpolate.interpn-compatible one-shot helper.

    ``dtype`` is this package's extension kwarg (see
    :class:`RegularGridInterpolator`): ``np.float32`` opts evaluation into
    the fused f32 engines; default None keeps scipy's float64 promotion.
    """
    rgi = RegularGridInterpolator(
        points,
        values,
        method=method,
        bounds_error=bounds_error,
        fill_value=fill_value,
        dtype=dtype,
    )
    return rgi(xi)
