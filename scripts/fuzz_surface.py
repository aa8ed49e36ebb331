"""Randomized PUBLIC-SURFACE parity fuzzer.

Where scripts/fuzz_parity.py crosses the compute ENGINES against each
other, this crosses the user-facing layers: for random configurations it
asserts that

  * `interpn()` (autodetect + dispatch),
  * the matching `raw.interpn_*` flat function (with a preallocated out),
  * the matching pydantic model class (`.eval` and `.eval_unchecked`),
  * the class rebuilt from `model_dump_json()` (byte-identical wire), and
  * the loop-based numpy oracle (tests/oracle.py)

all agree at dtype-appropriate tolerance, and that `check_bounds`
classifies every observation dimension exactly like a numpy recomputation
of the reference's rule (|violation| > atol outside [lo, hi]).

Run: python scripts/fuzz_surface.py [--rounds 100] [--seed 0]
Exit code != 0 on the first disagreement, printing a repro config.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)  # prepared_stack leg needs a mesh

import numpy as np

import oracle  # tests/oracle.py
import interpn_tpu as it

CLASSES = {
    ("linear", True): it.MultilinearRegular,
    ("linear", False): it.MultilinearRectilinear,
    ("cubic", True): it.MulticubicRegular,
    ("cubic", False): it.MulticubicRectilinear,
    ("nearest", True): it.NearestRegular,
    ("nearest", False): it.NearestRectilinear,
}

RAW = {
    ("linear", True): "interpn_linear_regular_{}",
    ("linear", False): "interpn_linear_rectilinear_{}",
    ("cubic", True): "interpn_cubic_regular_{}",
    ("cubic", False): "interpn_cubic_rectilinear_{}",
    ("nearest", True): "interpn_nearest_regular_{}",
    ("nearest", False): "interpn_nearest_rectilinear_{}",
}

ORACLE = {
    ("linear", True): oracle.linear_regular,
    ("linear", False): oracle.linear_rectilinear,
    ("cubic", True): oracle.cubic_regular,
    ("cubic", False): oracle.cubic_rectilinear,
    ("nearest", True): oracle.nearest_regular,
    ("nearest", False): oracle.nearest_rectilinear,
}


def _fail(idx, msg, **cfg):
    print(f"ROUND {idx} SURFACE MISMATCH: {msg}")
    print("  config:", {k: v for k, v in cfg.items()})
    sys.exit(1)


def _one_dim_round(rng: np.random.Generator, idx: int) -> None:
    """1D fast-path family vs a direct numpy recomputation of the
    reference's per-point semantics (src/one_dim/linear.rs, hold.rs)."""
    from interpn_tpu.ops.one_dim import (
        Left1D, Linear1D, LinearHoldLast1D, Nearest1D, RectilinearGrid1D,
        RegularGrid1D, Right1D,
    )

    n_grid = int(rng.integers(2, 12))
    regular = bool(rng.integers(0, 2))
    vals = rng.standard_normal(n_grid)
    if regular:
        start, step = float(rng.uniform(-2, 2)), float(rng.uniform(0.2, 1.5))
        grid = start + step * np.arange(n_grid)
        g = RegularGrid1D(start, step, vals)
    else:
        grid = np.cumsum(0.2 + rng.random(n_grid)) + rng.uniform(-3, 0)
        g = RectilinearGrid1D(grid, vals)
    n = int(rng.integers(1, 64))
    span = grid[-1] - grid[0]
    locs = rng.uniform(grid[0] - 0.5 * span, grid[-1] + 0.5 * span, n)

    # reference per-point semantics in plain numpy
    def sample(x):
        if regular:
            i = int(np.clip(np.floor((x - start) / step), 0, n_grid - 2))
            x0 = start + step * i
            x1 = x0 + step
        else:
            i = int(np.clip(np.searchsorted(grid, x, side="left") - 1, 0,
                            n_grid - 2))
            x0, x1 = grid[i], grid[i + 1]
        return x0, vals[i], x1, vals[i + 1], x < grid[0], x > grid[-1]

    expect = {k: np.empty(n) for k in ("lin", "hold", "left", "right", "near")}
    for j, x in enumerate(locs):
        x0, y0, x1, y1, low, high = sample(x)
        s = (y1 - y0) / (x1 - x0)
        expect["lin"][j] = y0 + s * (x - x0)
        expect["hold"][j] = y0 if low else (y1 if high else y0 + s * (x - x0))
        expect["left"][j] = y1 if high else y0
        expect["right"][j] = y0 if low else y1
        expect["near"][j] = y0 if abs(x - x1) >= abs(x - x0) else y1

    got = {
        "lin": Linear1D(g), "hold": LinearHoldLast1D(g),
        "left": Left1D(g), "right": Right1D(g), "near": Nearest1D(g),
    }
    for k, interp in got.items():
        a = np.asarray(interp.eval(locs))
        d = float(np.max(np.abs(a - expect[k])))
        if not (d < 1e-12):
            _fail(idx, f"one_dim {k}: abs {d:.3e}",
                  regular=regular, n_grid=n_grid, n=n)


def _compat_round(rng: np.random.Generator, idx: int) -> None:
    """scipy-adapter leg: interpn_tpu.compat vs scipy.interpolate itself
    on the methods where scipy defines the exact function (linear/slinear;
    nearest ties are unspecified in scipy, so nearest is crossed in-bounds
    away from midpoints by using continuous random points)."""
    import scipy.interpolate as si

    from interpn_tpu import compat

    ndims = int(rng.integers(1, 4))
    dims = [int(rng.integers(2, 7)) for _ in range(ndims)]
    grids = []
    for d in dims:
        g = np.sort(rng.uniform(-3, 3, d))
        while np.any(np.diff(g) <= 1e-2):
            g = np.sort(rng.uniform(-3, 3, d))
        # exercise the descending-axis flip half the time
        grids.append(g[::-1].copy() if rng.integers(0, 2) else g)
    trailing = (int(rng.integers(2, 4)),) if rng.integers(0, 2) else ()
    vals = rng.standard_normal(tuple(dims) + trailing)
    method = str(rng.choice(["linear", "slinear", "nearest", "pchip"]))
    if method == "pchip" and min(dims) < 4:
        method = "linear"  # scipy's own pchip minimum
    fill = [np.nan, None, 2.5][int(rng.integers(0, 3))]

    lo = np.array([min(g[0], g[-1]) for g in grids])
    hi = np.array([max(g[0], g[-1]) for g in grids])
    n = int(rng.integers(1, 64))
    span = hi - lo
    xi = rng.uniform(lo - 0.4 * span, hi + 0.4 * span, (n, ndims))
    if n > 2:
        xi[int(rng.integers(0, n)), int(rng.integers(0, ndims))] = np.nan

    cfg = dict(leg="compat", method=method, ndims=ndims, dims=dims,
               trailing=trailing, fill=str(fill), n=n)
    ours = compat.RegularGridInterpolator(
        tuple(grids), vals, method=method, bounds_error=False, fill_value=fill
    )
    theirs = si.RegularGridInterpolator(
        tuple(grids), vals, method=method, bounds_error=False, fill_value=fill
    )
    a = np.asarray(ours(xi))
    nan_rows = np.isnan(xi).any(axis=1)
    if method == "pchip" and ndims > 1 and nan_rows.any():
        # scipy's recursive ND pchip RAISES when a NaN coordinate lands in
        # any axis fitted before the last one (the NaN poisons the next
        # axis's fit data); this adapter returns NaN output per scipy's
        # documented NaN rule — a deliberate deviation. Pin our NaN-row
        # behavior and compare the finite rows only.
        if not np.all(np.isnan(np.asarray(a)[nan_rows])):
            _fail(idx, "compat pchip: NaN coordinate row not NaN", **cfg)
        a, xi = a[~nan_rows], xi[~nan_rows]
        if xi.shape[0] == 0:
            return
    b = np.asarray(theirs(xi))
    if a.shape != b.shape:
        _fail(idx, f"compat shape {a.shape} vs scipy {b.shape}", **cfg)
    # nearest midpoint ties are unspecified in scipy, but continuous random
    # points never land on one; everything else must agree to fp noise
    # (relative: pchip/linear extrapolation amplifies values by O(t^3))
    mism = ~(
        (np.abs(a - b) <= 1e-10 * np.maximum(1.0, np.abs(b)))
        | (np.isnan(a) & np.isnan(b))
    )
    if np.any(mism):
        d = float(np.nanmax(np.abs(a - b)))
        _fail(idx, f"compat vs scipy: {int(mism.sum())} mismatches, "
                   f"max abs {d:.3e}", **cfg)


def _bspline_round(rng: np.random.Generator, idx: int) -> None:
    """Global-spline leg: compat cubic/quintic vs the exact tensor-product
    interpolant (recursive 1-d make_interp_spline fits — scipy's own
    DEFINITION; scipy RGI's iterative N-d solver is too loose to be an
    oracle and fails to converge on many of these shapes)."""
    import scipy.interpolate as si

    from interpn_tpu import compat

    k = int(rng.choice([3, 5]))
    method = {3: "cubic", 5: "quintic"}[k]
    ndims = int(rng.integers(1, 4))
    dims = [int(rng.integers(k + 1, k + 4)) for _ in range(ndims)]
    grids = []
    for d in dims:
        g = np.sort(rng.uniform(-3, 3, d))
        while np.any(np.diff(g) <= 1e-2):
            g = np.sort(rng.uniform(-3, 3, d))
        grids.append(g)
    vals = rng.standard_normal(tuple(dims))
    lo = np.array([g[0] for g in grids])
    hi = np.array([g[-1] for g in grids])
    n = int(rng.integers(1, 24))
    span = hi - lo
    xi = rng.uniform(lo - 0.3 * span, hi + 0.3 * span, (n, ndims))
    cfg = dict(leg="bspline", method=method, ndims=ndims, dims=dims, n=n)

    a = np.asarray(
        compat.RegularGridInterpolator(
            tuple(grids), vals, method=method, bounds_error=False,
            fill_value=None,
        )(xi)
    )
    b = np.empty(n)
    for q, pt in enumerate(xi):
        data = vals
        for ax in range(ndims - 1, -1, -1):
            flat = np.moveaxis(data, ax, -1).reshape(-1, data.shape[ax])
            red = np.array(
                [si.make_interp_spline(grids[ax], row, k=k)(pt[ax]) for row in flat]
            )
            data = red.reshape(data.shape[:ax] + data.shape[ax + 1 :])
        b[q] = data
    mism = ~(np.abs(a - b) <= 1e-9 * np.maximum(1.0, np.abs(b)))
    if np.any(mism):
        _fail(idx, f"bspline vs exact fit: {int(mism.sum())} mismatches, "
                   f"max abs {float(np.max(np.abs(a - b))):.3e}", **cfg)


def _spline_model_round(rng: np.random.Generator, idx: int) -> None:
    """TensorSpline model leg (round 4): the persistent classes must agree
    with the one-shot `interpn()` path for the same method, survive the
    JSON wire round-trip bit-for-bit, and classify bounds like numpy."""
    method = str(rng.choice(["pchip", "cubic_spline", "quintic"]))
    k = {"pchip": 3, "cubic_spline": 3, "quintic": 5}[method]
    ndims = int(rng.integers(1, 4))
    dims = [int(rng.integers(k + 1, k + 4)) for _ in range(ndims)]
    regular = bool(rng.integers(0, 2))
    if regular:
        starts = rng.uniform(-2, 2, ndims)
        steps = rng.uniform(0.2, 1.5, ndims)
        grids = [s0 + st * np.arange(d) for s0, st, d in zip(starts, steps, dims)]
    else:
        grids = []
        for d in dims:
            g = np.sort(rng.uniform(-3, 3, d))
            while np.any(np.diff(g) <= 1e-2):
                g = np.sort(rng.uniform(-3, 3, d))
            grids.append(g)
    vals = rng.standard_normal(tuple(dims))
    lo = np.array([g[0] for g in grids])
    hi = np.array([g[-1] for g in grids])
    n = int(rng.integers(1, 48))
    span = hi - lo
    xi = rng.uniform(lo - 0.3 * span, hi + 0.3 * span, (n, ndims))
    obs = [np.ascontiguousarray(xi[:, i]) for i in range(ndims)]
    cfg = dict(leg="spline_model", method=method, ndims=ndims, dims=dims,
               regular=regular, n=n)

    if regular:
        m = it.TensorSplineRegular.new(
            dims, np.array([g[0] for g in grids]),
            np.array([g[1] - g[0] for g in grids]), vals.ravel(),
            method=method,
        )
    else:
        m = it.TensorSplineRectilinear.new(grids, vals.ravel(), method=method)
    a = m.eval(obs)
    b = it.interpn(obs, grids=grids, vals=vals, method=method)
    if not np.allclose(a, b, rtol=1e-12, atol=1e-12):
        _fail(idx, f"spline model vs interpn: max abs "
                   f"{float(np.max(np.abs(a - b))):.3e}", **cfg)
    m2 = type(m).model_validate_json(m.model_dump_json())
    if m2.model_dump_json() != m.model_dump_json():
        _fail(idx, "spline model JSON round-trip not byte-identical", **cfg)
    c = m2.eval(obs)
    if not np.array_equal(np.asarray(a), np.asarray(c)):
        _fail(idx, "spline model rebuilt-from-JSON eval differs", **cfg)
    flags = m.check_bounds(obs, atol=1e-8)
    want = np.array([
        bool(np.any((obs[i] < lo[i] - 1e-8) | (obs[i] > hi[i] + 1e-8)))
        for i in range(ndims)
    ])
    if not np.array_equal(np.asarray(flags), want):
        _fail(idx, "spline model check_bounds mismatch", **cfg)


def _compat_xi_forms_round(rng: np.random.Generator, idx: int) -> None:
    """xi-form leg (round 5): compat must give the same answers for every
    scipy-accepted xi shape — (n, ndim) arrays, arbitrary (..., ndim)
    leading shapes, tuples of broadcastable arrays — and the extension
    kwarg dtype=np.float32 must track the f64 answer at f32 accuracy."""
    from interpn_tpu import compat

    ndims = int(rng.integers(1, 4))
    dims = [int(rng.integers(6, 10)) for _ in range(ndims)]
    grids = []
    for d in dims:
        g = np.sort(rng.uniform(-3, 3, d))
        while np.any(np.diff(g) <= 5e-2):
            g = np.sort(rng.uniform(-3, 3, d))
        grids.append(g[::-1].copy() if rng.integers(0, 2) else g)
    trailing = (int(rng.integers(2, 4)),) if rng.integers(0, 2) else ()
    vals = rng.standard_normal(tuple(dims) + trailing)
    method = str(rng.choice(
        ["linear", "slinear", "nearest", "hermite", "cubic", "pchip"]
    ))
    lo = np.array([min(g[0], g[-1]) for g in grids])
    hi = np.array([max(g[0], g[-1]) for g in grids])
    span = hi - lo
    a, b = int(rng.integers(1, 6)), int(rng.integers(1, 6))
    n = a * b
    xi = rng.uniform(lo - 0.2 * span, hi + 0.2 * span, (n, ndims))
    cfg = dict(leg="compat_xi", method=method, ndims=ndims, dims=dims,
               trailing=trailing, n=n)

    rgi = compat.RegularGridInterpolator(
        tuple(grids), vals, method=method, bounds_error=False, fill_value=None
    )
    base = np.asarray(rgi(xi))

    # tuple of full-length arrays == column-split of the same points
    t = np.asarray(rgi(tuple(xi[:, i] for i in range(ndims))))
    if not np.array_equal(t, base, equal_nan=True):
        _fail(idx, "tuple xi form differs from (n, ndim) array", **cfg)

    # arbitrary leading shape (a, b, ndim)
    r = np.asarray(rgi(xi.reshape(a, b, ndims)))
    want_shape = (a, b) + trailing
    if r.shape != want_shape:
        _fail(idx, f"(a,b,ndim) xi shape {r.shape} != {want_shape}", **cfg)
    if not np.array_equal(r.reshape(base.shape), base, equal_nan=True):
        _fail(idx, "(a,b,ndim) xi values differ", **cfg)

    # broadcast tuple: per-axis vectors shaped for a cartesian product
    if ndims >= 2:
        axes = [np.sort(rng.uniform(lo[i], hi[i], int(rng.integers(2, 4))))
                for i in range(ndims)]
        shaped = []
        for i, ax in enumerate(axes):
            shp = [1] * ndims
            shp[i] = ax.size
            shaped.append(ax.reshape(shp))
        bcast = np.asarray(rgi(tuple(shaped)))
        mesh_pts = np.stack(
            np.meshgrid(*axes, indexing="ij"), axis=-1
        ).reshape(-1, ndims)
        direct = np.asarray(rgi(mesh_pts)).reshape(bcast.shape)
        if not np.array_equal(bcast, direct, equal_nan=True):
            _fail(idx, "broadcast tuple xi differs from explicit meshgrid",
                  **cfg)

    # dtype=np.float32 extension kwarg: f32 output tracking the f64 answer
    rgi32 = compat.RegularGridInterpolator(
        tuple(grids), vals, method=method, bounds_error=False,
        fill_value=None, dtype=np.float32,
    )
    r32 = np.asarray(rgi32(xi))
    if r32.dtype != np.float32:
        _fail(idx, f"dtype=f32 output dtype {r32.dtype}", **cfg)
    scale = float(np.nanmax(np.abs(base))) + 1.0
    finite = np.isfinite(base)
    if not np.array_equal(finite, np.isfinite(r32)):
        # nearest ties can flip at f32-rounded midpoints, but finiteness
        # (NaN propagation) must match exactly for every method
        _fail(idx, "dtype=f32 finiteness mask differs", **cfg)
    d = float(np.max(np.abs(r32[finite] - base[finite]))) / scale if finite.any() else 0.0
    # nearest can legitimately pick the other neighbor at an f32-rounded
    # midpoint; bound the frequency instead of the magnitude there
    if method == "nearest":
        frac = float(np.mean(np.abs(r32[finite] - base[finite]) > 1e-6 * scale)) if finite.any() else 0.0
        if frac > 0.2:
            _fail(idx, f"dtype=f32 nearest flipped {frac:.0%} of points", **cfg)
    elif not (d < 5e-4):
        _fail(idx, f"dtype=f32 vs f64: rel {d:.3e}", **cfg)


def _aot_round(rng: np.random.Generator, idx: int) -> None:
    """AOT leg (round 5): export_eval -> load -> eval_jax must reproduce the
    model's own eval at batch sizes bracketing every bucket boundary
    (1, b-1, b, b+1, ...), reject batches beyond the largest bucket, and
    pad/slice without perturbing any row."""
    from interpn_tpu import aot

    method = str(rng.choice(["linear", "cubic", "nearest",
                             "pchip", "cubic_spline", "quintic"]))
    floor = {"linear": 2, "cubic": 4, "nearest": 2,
             "pchip": 4, "cubic_spline": 4, "quintic": 6}[method]
    ndims = int(rng.integers(1, 4))
    dims = [int(rng.integers(floor, floor + 3)) for _ in range(ndims)]
    regular = bool(rng.integers(0, 2))
    dtype = np.float64 if rng.integers(0, 2) else np.float32
    if method in ("pchip", "cubic_spline", "quintic"):
        dtype = np.float64  # spline prep is f64 by contract
    starts = rng.uniform(-2, 2, ndims).astype(dtype)
    steps = rng.uniform(0.3, 1.5, ndims).astype(dtype)
    if regular:
        grids = [starts[k] + steps[k] * np.arange(dims[k], dtype=dtype)
                 for k in range(ndims)]
    else:
        grids = [
            (np.cumsum(0.3 + rng.random(d)) + rng.uniform(-3, 0)).astype(dtype)
            for d in dims
        ]
    vals = rng.standard_normal(int(np.prod(dims))).astype(dtype)
    cfg = dict(leg="aot", method=method, ndims=ndims, dims=dims,
               regular=regular, dtype=dtype.__name__)

    if method in ("pchip", "cubic_spline", "quintic"):
        if regular:
            m = it.TensorSplineRegular.new(dims, starts, steps, vals,
                                           method=method)
        else:
            m = it.TensorSplineRectilinear.new(grids, vals, method=method)
    else:
        cls = CLASSES[(method, regular)]
        if method == "cubic":
            args = (dims, starts, steps, vals) if regular else (grids, vals)
            m = cls.new(*args, linearize_extrapolation=bool(rng.integers(0, 2)))
        else:
            m = cls.new(dims, starts, steps, vals) if regular else cls.new(grids, vals)

    b1 = int(rng.integers(2, 9))
    b2 = b1 + int(rng.integers(1, 24))
    served = aot.load(aot.export_eval(m, [b1, b2]))
    tol = 1e-12 if dtype == np.float64 else 1e-5

    lo = np.array([g[0] for g in grids])
    hi = np.array([g[-1] for g in grids])
    span = hi - lo
    for n in sorted({1, b1 - 1, b1, b1 + 1, b2 - 1, b2}):
        if n < 1:
            continue
        obs = [rng.uniform(lo[k] - 0.2 * span[k], hi[k] + 0.2 * span[k], n)
               .astype(dtype) for k in range(ndims)]
        got = np.asarray(served.eval_jax(obs))
        want = np.asarray(m.eval(obs))
        scale = max(1.0, float(np.max(np.abs(want))))
        d = float(np.max(np.abs(got - want))) / scale
        if not (d < tol):
            _fail(idx, f"aot batch {n} (buckets {b1},{b2}): rel {d:.3e}", **cfg)
    try:
        served.eval_jax([np.zeros(b2 + 1, dtype) for _ in range(ndims)])
    except ValueError:
        pass
    else:
        _fail(idx, f"aot batch {b2 + 1} beyond largest bucket did not raise",
              **cfg)


_MESH = None


def _get_mesh():
    global _MESH
    if _MESH is None:
        from interpn_tpu import parallel

        _MESH = parallel.make_mesh()
    return _MESH


def _stack_prepared_round(rng: np.random.Generator, idx: int) -> None:
    """Sharded-stack leg (round 5): prepared_stack_evaluator on the 8-device
    mesh must match interpn_stack per channel at non-divisible batch sizes
    for every method family."""
    from interpn_tpu import parallel

    mesh = _get_mesh()
    method = str(rng.choice(["linear", "cubic", "nearest",
                             "pchip", "cubic_spline", "quintic"]))
    floor = {"linear": 2, "cubic": 4, "nearest": 2,
             "pchip": 4, "cubic_spline": 4, "quintic": 6}[method]
    ndims = int(rng.integers(1, 3))
    dims = [int(rng.integers(floor, floor + 3)) for _ in range(ndims)]
    regular = bool(rng.integers(0, 2))
    nch = int(rng.integers(2, 5))
    starts = rng.uniform(-2, 2, ndims)
    steps = rng.uniform(0.3, 1.5, ndims)
    if regular:
        grids = [starts[k] + steps[k] * np.arange(dims[k]) for k in range(ndims)]
        grid_arrays = (starts, steps)
    else:
        grids = [np.cumsum(0.3 + rng.random(d)) + rng.uniform(-3, 0)
                 for d in dims]
        grid_arrays = tuple(grids)
    vals = rng.standard_normal((nch, int(np.prod(dims))))
    n = int(rng.integers(1, 200))  # rarely divisible by 8 — exercises padding
    lo = np.array([g[0] for g in grids])
    hi = np.array([g[-1] for g in grids])
    span = hi - lo
    obs = tuple(rng.uniform(lo[k] - 0.2 * span[k], hi[k] + 0.2 * span[k], n)
                for k in range(ndims))
    cfg = dict(leg="stack_prepared", method=method, ndims=ndims, dims=dims,
               regular=regular, nch=nch, n=n)

    f = parallel.prepared_stack_evaluator(
        mesh, grid_arrays, vals,
        dims=tuple(dims) if regular else None,
        method=method, regular=regular,
    )
    padded = [parallel.pad_to_multiple(o, 8) for o in obs]
    obs_sh = parallel.shard_obs(tuple(p for p, _ in padded), mesh)
    got = np.asarray(f(obs_sh))[:, : n]
    want = np.asarray(
        it.interpn_stack([np.asarray(o) for o in obs], grids, vals,
                         method=method)
    )
    if got.shape != want.shape:
        _fail(idx, f"stack shape {got.shape} vs {want.shape}", **cfg)
    scale = max(1.0, float(np.max(np.abs(want))))
    d = float(np.max(np.abs(got - want))) / scale
    if not (d < 1e-11):
        _fail(idx, f"prepared_stack vs interpn_stack: rel {d:.3e}", **cfg)


def run_round(rng: np.random.Generator, idx: int) -> None:
    _one_dim_round(rng, idx)
    _compat_round(rng, idx)
    _bspline_round(rng, idx)
    _spline_model_round(rng, idx)
    _compat_xi_forms_round(rng, idx)
    _aot_round(rng, idx)
    _stack_prepared_round(rng, idx)
    method = rng.choice(["linear", "cubic", "nearest"])
    max_nd = 6 if method == "nearest" else 5  # keep oracle rounds fast
    ndims = int(rng.integers(1, max_nd + 1))
    regular = bool(rng.integers(0, 2))
    dtype = np.float64 if rng.integers(0, 2) else np.float32
    linearize = bool(rng.integers(0, 2))
    min_pts = 4 if method == "cubic" else 2
    dims = [int(rng.integers(min_pts, min_pts + 3)) for _ in range(ndims)]

    starts = rng.uniform(-2, 2, ndims).astype(dtype)
    steps = rng.uniform(0.3, 1.5, ndims).astype(dtype)
    grids = [
        (np.cumsum(0.2 + rng.random(d)) + rng.uniform(-3, 0)).astype(dtype)
        for d in dims
    ]
    vals = rng.standard_normal(int(np.prod(dims))).astype(dtype)
    n = int(rng.integers(1, 200))
    if regular:
        grids = [
            (starts[k] + steps[k] * np.arange(dims[k])).astype(dtype)
            for k in range(ndims)
        ]
    # span one cell of extrapolation on each side (mild region: every
    # layer must agree tightly there; deep-extrapolation divergence is
    # the engine fuzzer's domain)
    obs = [
        rng.uniform(g[0] - (g[1] - g[0]), g[-1] + (g[-1] - g[-2]), n).astype(dtype)
        for g in grids
    ]
    tol = 5e-12 if dtype == np.float64 else 2e-4

    cfg = dict(method=str(method), regular=regular, dtype=dtype.__name__,
               ndims=ndims, dims=dims, linearize=linearize, n=n)

    # layer 1: interpn()
    top = np.asarray(
        it.interpn(obs, grids=grids, vals=vals.reshape(dims), method=str(method),
                   linearize_extrapolation=linearize)
    )

    # layer 2: raw with preallocated out
    suffix = "f64" if dtype == np.float64 else "f32"
    fn = getattr(it.raw, RAW[(str(method), regular)].format(suffix))
    out = np.zeros(n, dtype)
    if method == "cubic":
        if regular:
            fn(dims, starts, steps, vals, linearize, obs, out)
        else:
            fn(grids, vals, linearize, obs, out)
    else:
        if regular:
            fn(dims, starts, steps, vals, obs, out)
        else:
            fn(grids, vals, obs, out)

    # layer 3: model class (+ JSON round-trip rebuild)
    cls = CLASSES[(str(method), regular)]
    if method == "cubic":
        if regular:
            m = cls.new(dims, starts, steps, vals, linearize_extrapolation=linearize)
        else:
            m = cls.new(grids, vals, linearize_extrapolation=linearize)
    else:
        m = cls.new(dims, starts, steps, vals) if regular else cls.new(grids, vals)
    mv = np.asarray(m.eval(obs))
    wire = m.model_dump_json()
    m2 = cls.model_validate_json(wire)
    if m2.model_dump_json() != wire:
        _fail(idx, "JSON wire not byte-stable across a round-trip", **cfg)
    mv2 = np.asarray(m2.eval_unchecked(obs))

    # layer 4: pytree interpolator lifted from the model (device-resident
    # functional surface; round-3 addition)
    from interpn_tpu.functional import JaxInterpolator

    fv = np.asarray(JaxInterpolator.from_model(m)(obs))

    # layer 5: stacked-table eval — channel 0 carries THIS round's table, so
    # it must agree with every other layer; channel 1 is an independent
    # table checked against its own one-shot interpn()
    vals2 = rng.standard_normal(vals.size).astype(dtype)
    stacked = np.asarray(
        it.interpn_stack(obs, grids, np.stack([vals, vals2]),
                         method=str(method),
                         linearize_extrapolation=linearize)
    )
    ch1_ref = np.asarray(
        it.interpn(obs, grids=grids, vals=vals2.reshape(dims),
                   method=str(method), linearize_extrapolation=linearize)
    )
    scale1 = max(1.0, float(np.max(np.abs(ch1_ref))))
    d1 = float(np.max(np.abs(stacked[1] - ch1_ref))) / scale1
    if not (d1 < tol):
        _fail(idx, f"stack ch1 vs interpn: rel {d1:.3e}", **cfg)

    # layer 6: oracle (f64 only — the oracle computes in f64)
    layers = {"interpn": top, "raw": out, "class": mv, "class-rt": mv2,
              "functional": fv, "stack-ch0": stacked[0]}
    if dtype == np.float64:
        orc = ORACLE[(str(method), regular)]
        pts = lambda i: [o[i] for o in obs]
        if method == "cubic":
            args = (dims, starts, steps, vals) if regular else (grids, vals)
            layers["oracle"] = np.array(
                [orc(*args, pts(i), linearize) for i in range(n)]
            )
        else:
            args = (dims, starts, steps, vals) if regular else (grids, vals)
            layers["oracle"] = np.array([orc(*args, pts(i)) for i in range(n)])

    ref_name, ref = next(iter(layers.items()))
    scale = max(1.0, float(np.max(np.abs(ref))))
    for nm, arr in layers.items():
        d = float(np.max(np.abs(arr - ref))) / scale
        if not (d < tol):
            _fail(idx, f"{ref_name} vs {nm}: rel {d:.3e}", **cfg)

    # check_bounds vs a same-dtype numpy recomputation of the reference
    # rule: violation iff (x - lo) <= -atol or (x - hi) >= atol
    # (regular.rs:158-171; ops/bounds.py)
    atol = dtype(rng.uniform(0, 0.5))
    flags = np.zeros(ndims, dtype=bool)
    if regular:
        cb = getattr(it.raw, f"check_bounds_regular_{suffix}")
        cb(dims, starts, steps, obs, atol, flags)
        first = starts
        # same op order as ops/bounds.py: starts + steps * (dims - 1)
        last = starts + steps * np.asarray([d - 1 for d in dims], dtype)
        lo, hi = np.minimum(first, last), np.maximum(first, last)
    else:
        cb = getattr(it.raw, f"check_bounds_rectilinear_{suffix}")
        cb(grids, obs, atol, flags)
        lo = np.array([g[0] for g in grids], dtype)
        hi = np.array([g[-1] for g in grids], dtype)
    for k in range(ndims):
        o = obs[k]
        expect = bool(np.any(((o - lo[k]) <= -atol) | ((o - hi[k]) >= atol)))
        if bool(flags[k]) != expect:
            _fail(idx, f"check_bounds axis {k}: got {flags[k]} want {expect}",
                  atol=float(atol), **cfg)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    for i in range(args.rounds):
        run_round(rng, i)
        if (i + 1) % 10 == 0:
            print(f"{i+1}/{args.rounds} rounds clean")
    print("ALL CLEAN")


if __name__ == "__main__":
    main()
