"""Tensor-product PCHIP engine: parity vs scipy and monotonicity properties.

scipy itself is the oracle (`PchipInterpolator` in 1D, RGI ``method='pchip'``
in N-d): the engine claims scipy-matched slopes (weighted harmonic mean,
Moler edge clamps) and recursion order (last axis first — load-bearing for a
value-nonlinear interpolant), so every case asserts against scipy outputs,
in-bounds AND under edge-polynomial extrapolation.
"""

from __future__ import annotations

import numpy as np
import pytest
import scipy.interpolate as si

from interpn_tpu import compat, ops


def _rect_grid(rng, n, span=1.0):
    g = np.sort(rng.uniform(0, span, n))
    while np.any(np.diff(g) <= 1e-3 * span):
        g = np.sort(rng.uniform(0, span, n))
    return g


def _rel(a, b):
    return np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b)))


def test_1d_matches_pchipinterpolator_with_clamp_branches():
    """Flat segments and sign flips exercise the zero-slope and 3*m0 edge
    clamps; queries span one grid-width of extrapolation per side."""
    rng = np.random.default_rng(0)
    g = _rect_grid(rng, 9, span=3.0)
    y = np.array([0.0, 1.0, 1.0, 2.0, -1.0, -1.0, 0.5, 3.0, 2.9])
    q = rng.uniform(-0.5, 3.5, 500)
    ref = si.PchipInterpolator(g, y, extrapolate=True)(q)
    got = np.asarray(ops.pchip_rectilinear([g], y, [q]))
    assert _rel(got, ref) < 1e-12

    x = np.linspace(0.0, 2.0, 7)
    y2 = rng.standard_normal(7)
    ref = si.PchipInterpolator(x, y2, extrapolate=True)(q)
    got = np.asarray(
        ops.pchip_regular((7,), np.array([0.0]), np.array([x[1] - x[0]]), y2, [q])
    )
    assert _rel(got, ref) < 1e-12


@pytest.mark.parametrize("dims", [(6, 7), (5, 6, 4), (4, 5, 4, 6)])
def test_nd_rectilinear_matches_scipy_rgi(dims):
    rng = np.random.default_rng(len(dims))
    grids = [_rect_grid(rng, d) for d in dims]
    v = rng.random(dims)
    r = si.RegularGridInterpolator(
        tuple(grids), v, method="pchip", bounds_error=False, fill_value=None
    )
    pts = rng.uniform(-0.2, 1.2, (60, len(dims)))
    ref = r(pts)
    got = np.asarray(
        ops.pchip_rectilinear(grids, v.ravel(), [pts[:, k] for k in range(len(dims))])
    )
    assert _rel(got, ref) < 1e-12


def test_regular_grid_matches_scipy_rgi():
    rng = np.random.default_rng(7)
    x = np.linspace(0.0, 1.0, 6)
    y = np.linspace(0.0, 2.0, 5)
    v = rng.random((6, 5))
    r = si.RegularGridInterpolator(
        (x, y), v, method="pchip", bounds_error=False, fill_value=None
    )
    pts = rng.uniform(-0.2, 1.2, (80, 2))
    pts[:, 1] *= 2.0
    ref = r(pts)
    got = np.asarray(
        ops.pchip_regular(
            (6, 5),
            np.array([0.0, 0.0]),
            np.array([x[1] - x[0], y[1] - y[0]]),
            v.ravel(),
            [pts[:, 0], pts[:, 1]],
        )
    )
    assert _rel(got, ref) < 1e-12


def test_axis_order_matches_scipy():
    """PCHIP is nonlinear in the data, so the recursion order is part of the
    function: scipy reduces the LAST axis first. Assert against an explicit
    per-axis recursion in both orders — the engine must match scipy's and
    (on data where it matters) differ from the reverse."""
    rng = np.random.default_rng(11)
    gx = _rect_grid(rng, 6)
    gy = _rect_grid(rng, 7)
    v = rng.random((6, 7))
    p = rng.uniform(0.2, 0.8, 2)

    col = np.array(
        [si.PchipInterpolator(gy, v[i], extrapolate=True)(p[1]) for i in range(6)]
    )
    y_first = float(si.PchipInterpolator(gx, col, extrapolate=True)(p[0]))
    row = np.array(
        [si.PchipInterpolator(gx, v[:, j], extrapolate=True)(p[0]) for j in range(7)]
    )
    x_first = float(si.PchipInterpolator(gy, row, extrapolate=True)(p[1]))
    got = float(
        np.asarray(
            ops.pchip_rectilinear([gx, gy], v.ravel(), [p[:1], p[1:]])
        )[0]
    )
    assert abs(got - y_first) < 1e-12
    assert abs(y_first - x_first) > 1e-6  # the order genuinely matters here
    assert abs(got - x_first) > 1e-6


def test_monotone_data_no_overshoot_and_node_reproduction():
    rng = np.random.default_rng(3)
    g = _rect_grid(rng, 8)
    y = np.sort(rng.standard_normal(8))
    q = rng.uniform(g[0], g[-1], 2000)
    got = np.asarray(ops.pchip_rectilinear([g], y, [q]))
    assert got.min() >= y.min() - 1e-15
    assert got.max() <= y.max() + 1e-15
    # rectilinear grid nodes reproduce bit-for-bit (regular grids are within
    # 1 ulp of the reconstructed node coordinate, like every regular engine)
    nodes = np.asarray(ops.pchip_rectilinear([g], y, [g]))
    assert np.array_equal(nodes, y)


def test_5d_chunked_tail_matches_scipy():
    """4^5 > LIST_MAX_VERTS exercises the vectorized matrix tree + chunking."""
    rng = np.random.default_rng(13)
    dims = (4, 4, 4, 4, 4)
    grids = [_rect_grid(rng, d) for d in dims]
    v = rng.random(dims)
    r = si.RegularGridInterpolator(
        tuple(grids), v, method="pchip", bounds_error=False, fill_value=None
    )
    pts = rng.uniform(-0.1, 1.1, (20, 5))
    ref = r(pts)
    got = np.asarray(
        ops.pchip_rectilinear(grids, v.ravel(), [pts[:, k] for k in range(5)])
    )
    assert _rel(got, ref) < 1e-12


def test_f32_runs_and_tracks_f64():
    rng = np.random.default_rng(17)
    g = [_rect_grid(rng, 6), _rect_grid(rng, 5)]
    v = rng.random((6, 5))
    pts = rng.uniform(0.0, 1.0, (50, 2))
    f64 = np.asarray(ops.pchip_rectilinear(g, v.ravel(), [pts[:, 0], pts[:, 1]]))
    f32 = np.asarray(
        ops.pchip_rectilinear(
            [x.astype(np.float32) for x in g],
            v.ravel().astype(np.float32),
            [pts[:, 0].astype(np.float32), pts[:, 1].astype(np.float32)],
        )
    )
    assert f32.dtype == np.float32
    assert _rel(f32.astype(np.float64), f64) < 1e-5


# ---- compat adapter ------------------------------------------------------


def test_compat_pchip_matches_scipy_full_semantics():
    """Descending axis + trailing channel dims + NaN coordinate + every
    fill_value mode, all against scipy RGI pchip."""
    rng = np.random.default_rng(5)
    gx = _rect_grid(rng, 6)
    gy = _rect_grid(rng, 7)[::-1]
    v = rng.random((6, 7, 2))
    xi = rng.uniform(-0.2, 1.2, (60, 2))
    xi[3, 0] = np.nan
    for fill in (None, np.nan, 3.25):
        ours = compat.RegularGridInterpolator(
            (gx, gy), v, method="pchip", bounds_error=False, fill_value=fill
        )
        theirs = si.RegularGridInterpolator(
            (gx, gy), v, method="pchip", bounds_error=False, fill_value=fill
        )
        a, b = ours(xi), theirs(xi)
        assert a.shape == b.shape
        rel = np.abs(a - b) / np.maximum(1.0, np.abs(b))
        assert np.all((rel <= 1e-11) | (np.isnan(a) & np.isnan(b)))


def test_compat_pchip_nan_in_later_axis_deviation():
    """scipy's recursive ND pchip raises when a NaN coordinate lands in an
    axis fitted before the last (the NaN poisons the next 1-d fit's data);
    this adapter applies scipy's documented NaN rule uniformly and returns
    NaN output. Deliberate deviation — documented in compat's module
    docstring; found by the surface fuzzer (seed 1313, round 11)."""
    rng = np.random.default_rng(6)
    g = (np.linspace(0, 1, 6), np.linspace(0, 1, 7))
    v = rng.random((6, 7))
    xi = np.array([[0.5, np.nan], [0.25, 0.75]])
    with pytest.raises(ValueError, match="finite"):
        si.RegularGridInterpolator(
            g, v, method="pchip", bounds_error=False, fill_value=None
        )(xi)
    ours = compat.RegularGridInterpolator(
        g, v, method="pchip", bounds_error=False, fill_value=None
    )(xi)
    assert np.isnan(ours[0]) and np.isfinite(ours[1])


def test_compat_pchip_min_points_message_matches_scipy():
    g = (np.arange(3.0),)
    v = np.zeros(3)
    with pytest.raises(ValueError) as e_theirs:
        si.RegularGridInterpolator(g, v, method="pchip")
    with pytest.raises(ValueError) as e_ours:
        compat.RegularGridInterpolator(g, v, method="pchip")
    assert str(e_ours.value) == str(e_theirs.value)


def test_compat_pchip_per_call_and_interpn():
    rng = np.random.default_rng(9)
    gx = _rect_grid(rng, 6)
    gy = _rect_grid(rng, 7)
    v = rng.random((6, 7))
    lo = np.array([gx[0], gy[0]])
    hi = np.array([gx[-1], gy[-1]])
    xi = rng.uniform(lo + 0.02, hi - 0.02, (40, 2))
    base = compat.RegularGridInterpolator((gx, gy), v)
    ref = si.RegularGridInterpolator((gx, gy), v)
    assert (
        _rel(base(xi, method="pchip"), ref(xi, method="pchip")) < 1e-11
    )
    a = compat.interpn((gx, gy), v, xi, method="pchip")
    b = si.interpn((gx, gy), v, xi, method="pchip")
    assert _rel(a, b) < 1e-11


def test_interpn_pchip_extension():
    """Top-level interpn() accepts method='pchip' with the raw layer's
    input contracts (grid floor, dtype strictness, bounds check, out=)."""
    import interpn_tpu as it

    rng = np.random.default_rng(21)
    # regular grid, autodetected
    x = np.linspace(0.0, 1.0, 6)
    y = np.linspace(0.0, 2.0, 5)
    v = rng.random((6, 5))
    obs = [rng.uniform(-0.2, 1.2, 100), rng.uniform(-0.2, 2.2, 100)]
    got = it.interpn(obs, grids=[x, y], vals=v, method="pchip")
    ref = si.RegularGridInterpolator(
        (x, y), v, method="pchip", bounds_error=False, fill_value=None
    )(np.stack(obs, -1))
    assert _rel(got, ref) < 1e-12

    # rectilinear with a preallocated out buffer
    gr = [_rect_grid(rng, 6), _rect_grid(rng, 7)]
    v2 = rng.random((6, 7))
    o2 = [rng.uniform(0.0, 1.0, 50), rng.uniform(0.0, 1.0, 50)]
    buf = np.zeros(50)
    it.interpn(o2, grids=gr, vals=v2, method="pchip", out=buf)
    ref2 = si.RegularGridInterpolator(
        tuple(gr), v2, method="pchip", bounds_error=False, fill_value=None
    )(np.stack(o2, -1))
    assert _rel(buf, ref2) < 1e-12

    # contracts: grid floor, dtype strictness, bounds ValueError
    with pytest.raises(AssertionError, match="at least four entries"):
        it.interpn([np.zeros(3)], grids=[np.arange(3.0)], vals=np.zeros(3),
                    method="pchip")
    with pytest.raises(AssertionError, match="at least 4 entries"):
        it.interpn([np.zeros(3)], grids=[np.arange(3.0) ** 1.5],
                    vals=np.zeros(3), method="pchip")
    with pytest.raises(TypeError, match="expected a float64 array"):
        it.interpn([np.zeros(3, np.float32)], grids=[np.arange(5.0)],
                    vals=np.zeros(5), method="pchip")
    with pytest.raises(ValueError, match="violate interpolator bounds"):
        it.interpn([np.array([5.0]), np.array([0.5])], grids=gr, vals=v2,
                    method="pchip", check_bounds=True)
    # f32 runs and returns f32
    got32 = it.interpn(
        [o.astype(np.float32) for o in o2],
        grids=[g.astype(np.float32) for g in gr],
        vals=v2.astype(np.float32), method="pchip",
    )
    assert got32.dtype == np.float32
    assert _rel(got32.astype(np.float64), ref2) < 1e-4


def test_pchip_value_nonlinearity_pins_no_fused_engine():
    """pchip is NONLINEAR in the value table: f(a*v1 + b*v2) differs from
    a*f(v1) + b*f(v2). A contraction engine evaluates weights(x) @ table — a
    LINEAR functional of the table — so none can represent pchip,
    and the precomputed-slope "separable Hermite" proposal only matches the
    last-reduced axis (slopes elsewhere depend on already-reduced, hence
    query-dependent, values). This pins the dispatch decision: gather tree
    on every backend."""
    rng = np.random.default_rng(77)
    dims = (6, 6)
    g = [np.arange(d, dtype=float) for d in dims]
    v1 = rng.standard_normal(dims)
    v2 = rng.standard_normal(dims)
    obs = [rng.uniform(0.2, 4.8, 64) for _ in dims]
    import interpn_tpu as it

    def f(v):
        return it.interpn(obs, grids=g, vals=v, method="pchip")

    combined = f(0.3 * v1 + 0.7 * v2)
    superposed = 0.3 * f(v1) + 0.7 * f(v2)
    # materially different, not fp noise
    assert np.max(np.abs(combined - superposed)) > 1e-3

    # the linear-in-data cubic Hermite family, by contrast, superposes
    def h(v):
        return it.interpn(obs, grids=g, vals=v, method="cubic")

    np.testing.assert_allclose(
        h(0.3 * v1 + 0.7 * v2), 0.3 * h(v1) + 0.7 * h(v2), atol=1e-12
    )
