"""The gather tree against independent references on the shapes and tables
that once exercised the fused contraction engines: awkward grid shapes
(non-square, 4-5D, 8^5, 20^3), deep extrapolation, offset and spiky
tables, near-cancelling spline coefficients.

References: tests/oracle.py (a per-point numpy transliteration of the
reference semantics) for the reference methods, and scipy's recursive 1-d
`make_interp_spline` fits for the global splines. Oracles are slow, so
each case evaluates the full batch on the device path and compares a
fixed-seed subsample.

Tolerances:
* f64: 1e-13 relative to the larger of max|vals| and max|reference|
  (the reference's parity bar), with the deep-extrapolation cases scaled
  by the stencil-term amplification stated beside them.
* f32: 1e-5 relative to the larger of max|vals| and max|reference|: f32
  rounding of the inputs and of the cubic tree, amplified by up to two
  cells of extrapolation.
* nearest: exact.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import scipy.interpolate as si

import interpn_tpu  # noqa: F401  (enables x64)
import jax
import jax.numpy as jnp

from interpn_tpu import ops
from interpn_tpu.ops import bspline

from . import oracle

_TOL = {np.float64: 1e-13, np.float32: 1e-5}


def _regular_case(dims, seed=0, dtype=np.float64, n=700, depth=2.0):
    rng = np.random.default_rng(seed)
    starts = rng.uniform(-1, 1, len(dims)).astype(dtype)
    steps = rng.uniform(0.3, 1.0, len(dims)).astype(dtype)
    vals = rng.standard_normal(int(np.prod(dims))).astype(dtype)
    obs = [
        rng.uniform(
            starts[k] - depth * steps[k], starts[k] + steps[k] * (dims[k] - 1 + depth), n
        ).astype(dtype)
        for k in range(len(dims))
    ]
    return starts, steps, vals, obs


def _rect_case(dims, seed=0, dtype=np.float64, n=700, pad=1.0):
    rng = np.random.default_rng(seed)
    grids = [np.cumsum(0.2 + rng.random(d)).astype(dtype) for d in dims]
    vals = rng.standard_normal(int(np.prod(dims))).astype(dtype)
    obs = [rng.uniform(g[0] - pad, g[-1] + pad, n).astype(dtype) for g in grids]
    return grids, vals, obs


def _sel(n, k=96, seed=0):
    return np.random.default_rng(seed).choice(n, size=min(k, n), replace=False)


def _regular_eval(method, dims, starts, steps, vals, obs, lin=True):
    j = jnp.asarray
    args = (tuple(dims), j(starts), j(steps), j(vals), tuple(j(o) for o in obs))
    if method == "cubic":
        return np.asarray(ops.cubic_regular(*args, lin))
    return np.asarray(getattr(ops, f"{method}_regular")(*args))


def _rect_eval(method, grids, vals, obs, lin=True):
    j = jnp.asarray
    args = (tuple(j(g) for g in grids), j(vals), tuple(j(o) for o in obs))
    if method == "cubic":
        return np.asarray(ops.cubic_rectilinear(*args, lin))
    return np.asarray(getattr(ops, f"{method}_rectilinear")(*args))


def _regular_oracle(method, dims, starts, steps, vals, obs, sel, lin=True):
    f64 = lambda a: np.asarray(a, np.float64)
    st, sp, v = f64(starts), f64(steps), f64(vals)
    pts = [[float(o[i]) for o in obs] for i in sel]
    if method == "cubic":
        return np.array([oracle.cubic_regular(list(dims), st, sp, v, p, lin) for p in pts])
    fn = getattr(oracle, f"{method}_regular")
    return np.array([fn(list(dims), st, sp, v, p) for p in pts])


def _rect_oracle(method, grids, vals, obs, sel, lin=True):
    gs = [np.asarray(g, np.float64) for g in grids]
    v = np.asarray(vals, np.float64)
    pts = [[float(o[i]) for o in obs] for i in sel]
    if method == "cubic":
        return np.array([oracle.cubic_rectilinear(gs, v, p, lin) for p in pts])
    fn = getattr(oracle, f"{method}_rectilinear")
    return np.array([fn(gs, v, p) for p in pts])


def _check(got, ref, vals, dtype, method, amp=1.0):
    if method == "nearest":
        np.testing.assert_array_equal(got, ref.astype(got.dtype))
        return
    scale = max(float(np.abs(vals).max()), float(np.abs(ref).max()), 1.0)
    err = float(np.abs(got - ref).max())
    assert err <= _TOL[dtype] * amp * scale, (err, _TOL[dtype] * amp * scale)


# ---------------------------------------------------------------------------
# Regular and rectilinear grids in both dtypes
# ---------------------------------------------------------------------------

_REGULAR_SHAPES = [
    ("linear", (8, 12)),
    ("linear", (10, 10, 10)),
    ("linear", (6, 5, 4, 7)),
    ("linear", (20, 20, 20)),
    ("cubic", (8, 8, 8)),
    ("cubic", (4, 5, 4, 5, 4)),
    ("cubic", (20, 20, 20)),
    ("nearest", (9, 11, 7)),
    ("nearest", (20, 20, 20)),
    ("nearest", (8, 8, 8, 8, 8)),
]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("method,dims", _REGULAR_SHAPES)
def test_regular_matches_oracle(method, dims, dtype):
    starts, steps, vals, obs = _regular_case(dims, seed=sum(dims), dtype=dtype)
    got = _regular_eval(method, dims, starts, steps, vals, obs)
    sel = _sel(len(obs[0]))
    ref = _regular_oracle(method, dims, starts, steps, vals, obs, sel)
    _check(got[sel], ref, vals, dtype, method)


_RECT_SHAPES = [
    ("linear", (8, 12)),
    ("linear", (10, 10, 10)),
    ("linear", (6, 5, 4, 7)),
    ("linear", (20, 20, 20)),
    ("cubic", (8, 9, 10)),
    ("cubic", (20, 20, 20)),
    ("nearest", (9, 11, 7)),
    ("nearest", (20, 20, 20)),
]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("method,dims", _RECT_SHAPES)
def test_rectilinear_matches_oracle(method, dims, dtype):
    grids, vals, obs = _rect_case(dims, seed=sum(dims) + 1, dtype=dtype)
    got = _rect_eval(method, grids, vals, obs)
    sel = _sel(len(obs[0]))
    ref = _rect_oracle(method, grids, vals, obs, sel)
    _check(got[sel], ref, vals, dtype, method)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("regular", [True, False])
def test_cubic_not_linearized_matches_oracle(regular, dtype):
    """Hermite (non-linearized) extrapolation up to two cells out."""
    if regular:
        dims = (8, 8, 8)
        starts, steps, vals, obs = _regular_case(dims, seed=3, dtype=dtype)
        got = _regular_eval("cubic", dims, starts, steps, vals, obs, lin=False)
        sel = _sel(len(obs[0]))
        ref = _regular_oracle("cubic", dims, starts, steps, vals, obs, sel, lin=False)
    else:
        grids, vals, obs = _rect_case((8, 9, 10), seed=3, dtype=dtype)
        got = _rect_eval("cubic", grids, vals, obs, lin=False)
        sel = _sel(len(obs[0]))
        ref = _rect_oracle("cubic", grids, vals, obs, sel, lin=False)
    _check(got[sel], ref, vals, dtype, "cubic")


@pytest.mark.parametrize(
    "method,dims",
    [("linear", (13, 13, 13, 4)), ("cubic", (13, 13, 13, 4)), ("cubic", (6, 10, 10, 6, 4))],
)
def test_high_dim_f64_matches_oracle(method, dims):
    starts, steps, vals, obs = _regular_case(dims, seed=int(np.sum(dims)), n=400)
    got = _regular_eval(method, dims, starts, steps, vals, obs)
    sel = _sel(len(obs[0]), 48)
    ref = _regular_oracle(method, dims, starts, steps, vals, obs, sel)
    _check(got[sel], ref, vals, np.float64, method)


def test_large_grid_cubic_f64_matches_oracle():
    """A 50^3 table (125k cells) with a cell of extrapolation."""
    rng = np.random.default_rng(11)
    dims = (50, 50, 50)
    starts, steps = np.zeros(3), np.ones(3)
    vals = rng.standard_normal(int(np.prod(dims)))
    obs = [rng.uniform(-1.0, d, 256) for d in dims]
    got = _regular_eval("cubic", dims, starts, steps, vals, obs)
    sel = _sel(256, 64)
    ref = _regular_oracle("cubic", dims, starts, steps, vals, obs, sel)
    _check(got[sel], ref, vals, np.float64, "cubic")


# ---------------------------------------------------------------------------
# Adversarial tables (f64)
# ---------------------------------------------------------------------------


def _table_case(kind, rng):
    dims = (20, 20, 20)
    n = int(np.prod(dims))
    if kind == "offset":  # temperatures ~300 with tiny local variation
        vals = 300.0 + 0.01 * rng.standard_normal(n)
    elif kind == "row_offsets":  # per-row offsets spanning 1e6
        vals = (
            1.0e6 * np.linspace(-1.0, 1.0, 400)[:, None]
            + 0.01 * rng.standard_normal((400, 20))
        ).reshape(-1)
    elif kind == "spiky":  # one huge value amid tiny ones
        vals = np.ones(n) * 1e-6
        vals[40] = 1e6
    elif kind == "wide_span":  # value span beyond float32's range
        vals = rng.standard_normal(n) * 1e39
    elif kind == "huge_offset":  # huge magnitude, modest span
        vals = 1e39 + rng.standard_normal(n)
    else:  # checkerboard: maximal cancellation between stencil terms
        idx = np.indices(dims).sum(axis=0).ravel()
        vals = (-1.0) ** idx * (1.0 + 1e-3 * rng.standard_normal(n))
    return dims, vals


@pytest.mark.parametrize(
    "kind", ["offset", "row_offsets", "spiky", "wide_span", "huge_offset", "alternating"]
)
@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_adversarial_tables_match_oracle(kind, method):
    rng = np.random.default_rng(21)
    dims, vals = _table_case(kind, rng)
    starts, steps = np.zeros(3), np.ones(3)
    obs = [rng.uniform(-0.5, 19.5, 300) for _ in range(3)]
    got = _regular_eval(method, dims, starts, steps, vals, obs)
    sel = _sel(300, 64)
    ref = _regular_oracle(method, dims, starts, steps, vals, obs, sel)
    _check(got[sel], ref, vals, np.float64, method)


@pytest.mark.parametrize("dims,lin", [((20, 20, 20), False), ((20, 20, 20, 20), True)])
def test_deep_extrapolation_matches_oracle(dims, lin):
    """0.5-3 cells out on every axis at once. Non-linearized cubic grows
    like |t|^3 per axis out there, so the bar scales by that amplification
    (<= 4^3 for three cells)."""
    rng = np.random.default_rng(17)
    nd = len(dims)
    starts, steps = np.zeros(nd), np.ones(nd)
    vals = rng.standard_normal(int(np.prod(dims)))
    n = 300
    obs = [
        np.concatenate([
            rng.uniform(-3.0, -0.5, n // 2),
            rng.uniform(dims[k] - 0.5, dims[k] + 2.0, n - n // 2),
        ])
        for k in range(nd)
    ]
    got = _regular_eval("cubic", dims, starts, steps, vals, obs, lin=lin)
    sel = _sel(n, 48)
    ref = _regular_oracle("cubic", dims, starts, steps, vals, obs, sel, lin=lin)
    _check(got[sel], ref, vals, np.float64, "cubic", amp=1.0 if lin else 64.0)


@pytest.mark.parametrize("depth", [1.5, 4.0])
def test_6d_extrapolation_depths_match_oracle(depth):
    """A 6D (4,5,4,4,5,4) table, non-linearized cubic, queries up to
    `depth` cells beyond both edges of every axis; the bar scales by the
    |t|^3-per-axis term amplification."""
    dims = (4, 5, 4, 4, 5, 4)
    nd = len(dims)
    rng = np.random.default_rng(3)
    starts, steps = np.zeros(nd), np.ones(nd)
    vals = rng.standard_normal(int(np.prod(dims)))
    obs = [rng.uniform(-depth, d - 1 + depth, 64) for d in dims]
    got = _regular_eval("cubic", dims, starts, steps, vals, obs, lin=False)
    sel = _sel(64, 24)
    ref = _regular_oracle("cubic", dims, starts, steps, vals, obs, sel, lin=False)
    _check(got[sel], ref, vals, np.float64, "cubic", amp=(depth + 1.0) ** 3)


def test_fuzz_seed_300_regression_matches_oracle():
    """The 6D configuration a fuzz run once broke (random starts/steps,
    3-cell non-linearized extrapolation) holds the f64 bar on the gather
    tree."""
    rng = np.random.default_rng(300)
    dims = (4, 5, 4, 4, 5, 4)
    nd = len(dims)
    starts = rng.uniform(-3, 3, nd)
    steps = rng.uniform(0.2, 2.0, nd)
    vals = rng.standard_normal(int(np.prod(dims)))
    n = 2048
    obs = [rng.uniform(starts[k] - 3, starts[k] + steps[k] * (dims[k] + 3), n) for k in range(nd)]
    got = _regular_eval("cubic", dims, starts, steps, vals, obs, lin=False)
    sel = rng.integers(0, n, 48)
    ref = _regular_oracle("cubic", dims, starts, steps, vals, obs, sel, lin=False)
    scale = max(1.0, np.abs(ref).max())
    assert np.abs(got[sel] - ref).max() / scale < 1e-12


# ---------------------------------------------------------------------------
# Exact properties
# ---------------------------------------------------------------------------


def test_cubic_exact_at_grid_nodes_f32():
    """f32 cubic reproduces grid values bit-for-bit at the nodes."""
    dims = (20, 20, 20)
    rng = np.random.default_rng(17)
    vals = rng.standard_normal(int(np.prod(dims))).astype(np.float32)
    starts = np.zeros(3, np.float32)
    steps = np.full(3, 0.5, np.float32)
    idx = rng.integers(0, 20, (3, 700))
    obs = [(idx[k] * 0.5).astype(np.float32) for k in range(3)]
    flat = (idx[0] * 20 + idx[1]) * 20 + idx[2]
    got = _regular_eval("cubic", dims, starts, steps, vals, obs)
    np.testing.assert_array_equal(got, vals[flat])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_polynomial_reproduction_property(dtype):
    """The reference's property tests: linear reproduces sum(x_i) over
    every interp/extrap combination; cubic reproduces a quadratic even
    under non-linearized extrapolation (`src/multicubic/regular.rs:680-730`)."""
    dims = (20, 20, 20)
    starts = np.zeros(3, dtype)
    steps = np.full(3, 0.5, dtype)
    axes = [np.arange(20, dtype=dtype) * dtype(0.5) for _ in range(3)]
    mesh = np.meshgrid(*axes, indexing="ij")
    pts = list(itertools.product([-0.8, 4.6, 10.3], repeat=3))
    obs = [np.array([p[k] for p in pts], dtype) for k in range(3)]
    lin_vals = sum(mesh).ravel().astype(dtype)
    got = _regular_eval("linear", dims, starts, steps, lin_vals, obs)
    tol = 2e-5 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got, np.sum(np.stack(obs), axis=0), rtol=tol, atol=tol)
    quad = sum((m - 3.0) ** 2 for m in mesh).ravel().astype(dtype)
    got = _regular_eval("cubic", dims, starts, steps, quad, obs, lin=False)
    expect = np.sum(np.stack([(o.astype(np.float64) - 3.0) ** 2 for o in obs]), axis=0)
    tol = 2e-4 if dtype == np.float32 else 1e-10
    np.testing.assert_allclose(got, expect, rtol=tol, atol=tol)


def test_quadratic_extrapolation_f64_2d():
    """Quadratic reproduced under 2-cell extrapolation at f64 accuracy
    (the reference asserts atol 1e-10)."""
    dims = (12, 12)
    axes = [np.arange(12, dtype=np.float64) for _ in range(2)]
    mesh = np.meshgrid(*axes, indexing="ij")
    vals = sum((m - 4.0) ** 2 for m in mesh).ravel()
    rng = np.random.default_rng(3)
    obs = [rng.uniform(-2.0, 13.0, 500) for _ in range(2)]
    got = _regular_eval("cubic", dims, np.zeros(2), np.ones(2), vals, obs, lin=False)
    np.testing.assert_allclose(got, sum((o - 4.0) ** 2 for o in obs), rtol=1e-10, atol=1e-9)


def test_jvp_through_jit_matches_eager_jvp():
    """jax.jvp of an already-jitted dispatch call (AD applied to a stored
    jaxpr) gives the same tangent as the eager gather tree."""
    dims = (20, 20, 20)
    starts = jnp.zeros(3, jnp.float32)
    steps = jnp.full(3, 0.5, jnp.float32)
    rng = np.random.default_rng(5)
    vals = jnp.asarray(rng.standard_normal(8000), jnp.float32)
    rest = (jnp.full(2048, 3.3, jnp.float32), jnp.full(2048, 4.4, jnp.float32))
    f = jax.jit(lambda x: ops.cubic_regular(dims, starts, steps, vals, (x, *rest), True))
    x0 = jnp.asarray(rng.uniform(0, 9.5, 2048), jnp.float32)
    y, dy = jax.jvp(f, (x0,), (jnp.ones_like(x0),))
    gref = lambda x: ops.cubic.cubic_regular(dims, starts, steps, vals, (x, *rest), True)
    yr, dyr = jax.jvp(gref, (x0,), (jnp.ones_like(x0),))
    np.testing.assert_allclose(np.asarray(y), np.asarray(yr), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(dy), np.asarray(dyr), rtol=1e-5, atol=1e-5)
    g = jax.grad(lambda x: jnp.sum(f(x)))(x0)
    assert np.isfinite(np.asarray(g)).all()


# ---------------------------------------------------------------------------
# Global splines vs scipy's recursive 1-d fits
# ---------------------------------------------------------------------------


def _recursive_fit(grids, vals, xi, k):
    """scipy's definitional evaluation: 1-d not-a-knot fits, last axis
    first (the fit is linear in the data, so order is irrelevant)."""
    out = np.empty(len(xi))
    for q, pt in enumerate(xi):
        data = vals
        for ax in range(len(grids) - 1, -1, -1):
            flat = np.moveaxis(data, ax, -1).reshape(-1, data.shape[ax])
            red = np.array(
                [si.make_interp_spline(grids[ax], row, k=k)(pt[ax]) for row in flat]
            )
            data = red.reshape(data.shape[:ax] + data.shape[ax + 1 :])
        out[q] = data
    return out


def _spline_case(k, dims, seed, n=512, ext=0.2):
    rng = np.random.default_rng(seed)
    grids = [np.sort(rng.uniform(-2, 2, d)) for d in dims]
    for g in grids:
        while np.any(np.diff(g) <= 5e-2):
            g[:] = np.sort(rng.uniform(-2, 2, g.size))
    vals = rng.standard_normal(dims)
    lo = np.array([g[0] for g in grids])
    hi = np.array([g[-1] for g in grids])
    xi = rng.uniform(lo - ext * (hi - lo), hi + ext * (hi - lo), (n, len(dims)))
    return grids, vals, xi


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize(
    "k,dims", [(3, (8, 7, 6)), (3, (6, 9)), (5, (7, 8)), (5, (7, 7, 7)), (3, (11,))]
)
def test_spline_matches_recursive_fit(k, dims, dtype):
    """Coefficients and evaluation in `dtype`, extrapolating 20% beyond
    the data. The bar is relative to max|coeffs|: not-a-knot coefficients
    on short random axes can exceed the data scale by orders of magnitude,
    and the evaluation error scales with them."""
    grids, vals, xi = _spline_case(k, dims, seed=k + len(dims))
    knots, coeffs = bspline.prep_bspline(grids, vals.ravel(), k)
    obs = tuple(jnp.asarray(xi[:, i], dtype) for i in range(len(dims)))
    kt = tuple(jnp.asarray(t, dtype) for t in knots)
    got = np.asarray(bspline.bspline_eval(kt, jnp.asarray(coeffs, dtype), obs, k))
    sel = _sel(len(xi), 24)
    ref = _recursive_fit(grids, vals, xi[sel], k)
    cs = max(float(np.abs(coeffs).max()), 1.0)
    tol = 1e-10 if dtype == np.float64 else 1e-5
    assert np.abs(got[sel] - ref).max() <= tol * cs


def test_spline_4d_cubic_matches_recursive_fit():
    """A (14,14,14,6) cubic spline: a 4D table with a 4^4 stencil."""
    grids, vals, xi = _spline_case(3, (14, 14, 14, 6), seed=3, n=256, ext=0.05)
    knots, coeffs = bspline.prep_bspline(grids, vals.ravel(), 3)
    obs = [np.ascontiguousarray(xi[:, i]) for i in range(4)]
    got = np.asarray(bspline.bspline_eval(knots, coeffs, obs, 3))
    sel = _sel(len(xi), 8)
    ref = _recursive_fit(grids, vals, xi[sel], 3)
    cs = max(float(np.abs(coeffs).max()), 1.0)
    assert np.abs(got[sel] - ref).max() <= 1e-10 * cs


def test_quintic_near_cancellation_matches_bspline():
    """A 1-D quintic whose not-a-knot coefficients carry +/-871
    adjacent-cancelling terms, against scipy's BSpline on the same knots
    and coefficients."""
    knots = np.array(
        [-1.31354049] * 6 + [0.3537286, 0.4248704, 0.52182251] + [1.89405187] * 6
    )
    coeffs = np.array([
        4.36346804e-01, -8.71401680e+02, 8.68928869e+02, -1.59137663e+02,
        1.33095085e+02, -1.07417554e+02, 2.74165433e+02, -1.77141578e+02,
        -1.07698133e+00,
    ])
    rng = np.random.default_rng(7)
    lo, hi = knots[0], knots[-1]
    x = rng.uniform(lo - 0.2 * (hi - lo), hi + 0.2 * (hi - lo), 110)
    got = np.asarray(bspline.bspline_eval((jnp.asarray(knots),), jnp.asarray(coeffs), (jnp.asarray(x),), 5))
    ref = si.BSpline(knots, coeffs, 5, extrapolate=True)(x)
    cs = float(np.abs(coeffs).max())
    assert np.abs(got - ref).max() <= 1e-12 * cs


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spline_stack_matches_per_channel(dtype):
    """bspline_eval_stack (vmap over coefficient tables) equals per-channel
    evaluation, and its gradient equals the per-channel gradient."""
    rng = np.random.default_rng(21)
    dims = (8, 7, 6)
    grids = [np.sort(rng.uniform(-2, 2, d)) for d in dims]
    nch, n = 3, 2048
    vstack = rng.standard_normal((nch, int(np.prod(dims))))
    knots, coeffs = bspline.prep_bspline(grids, np.ascontiguousarray(vstack.T), 3)
    kt = tuple(jnp.asarray(t, dtype) for t in knots)
    ct = jnp.asarray(np.ascontiguousarray(coeffs.T), dtype)
    obs = tuple(jnp.asarray(rng.uniform(g[0], g[-1], n), dtype) for g in grids)
    got = np.asarray(bspline.bspline_eval_stack(kt, ct, obs, 3))
    assert got.shape == (nch, n)
    ref = np.stack([np.asarray(bspline.bspline_eval(kt, ct[c], obs, 3)) for c in range(nch)])
    cs = max(float(np.abs(coeffs).max()), 1.0)
    assert np.abs(got - ref).max() <= _TOL[dtype] * cs
    g = jax.grad(lambda c: jnp.sum(bspline.bspline_eval_stack(kt, c, obs, 3)))(ct)
    gref = jax.grad(
        lambda c: sum(jnp.sum(bspline.bspline_eval(kt, c[i], obs, 3)) for i in range(nch))
    )(ct)
    np.testing.assert_allclose(np.asarray(g), np.asarray(gref), rtol=1e-5, atol=1e-5)
