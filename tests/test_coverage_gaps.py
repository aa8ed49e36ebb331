"""Targeted behavioral tests for branches the main suites leave dark
(round 3 — raising the real, measured coverage gate toward the
reference's 94, `/root/reference/pyproject.toml:88`). Every test here
exercises genuine behavior: device-path tails of the raw entry points,
validator failure branches per class, ctypes fallbacks, profiling
helpers, and dispatch override fallbacks."""

import numpy as np
import pytest
from pydantic import ValidationError

import interpn_tpu as it
import jax
import jax.numpy as jnp

from interpn_tpu import native, raw
from interpn_tpu.utils import testing as itesting


def _grid2(dtype=np.float64, n=6):
    rng = itesting.rng_fixed_seed(0)
    x = np.arange(float(n), dtype=dtype)
    vals = rng.standard_normal(n * n).astype(dtype)
    return x, vals


# ---------------------------------------------------------------------------
# raw entry points: device-path tails (jax-array inputs skip the native
# fast path, so _prep/_finish/core run)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_all_16_raw_functions_device_path(dtype):
    x, vals = _grid2(dtype)
    j = jnp.asarray
    dims = np.array([6, 6])
    starts = np.zeros(2, dtype)
    steps = np.ones(2, dtype)
    grids = [x, x]
    rng = itesting.rng_fixed_seed(1)
    obs = [j(rng.uniform(0, 5, 64).astype(dtype)) for _ in range(2)]
    out = np.zeros(64, dtype)
    f = "f64" if dtype == np.float64 else "f32"

    r1 = getattr(raw, f"interpn_linear_regular_{f}")(
        dims, j(starts), j(steps), j(vals), obs, j(out)
    )
    r2 = getattr(raw, f"interpn_linear_rectilinear_{f}")(
        [j(g) for g in grids], j(vals), obs, j(out)
    )
    r3 = getattr(raw, f"interpn_nearest_regular_{f}")(
        dims, j(starts), j(steps), j(vals), obs, j(out)
    )
    r4 = getattr(raw, f"interpn_nearest_rectilinear_{f}")(
        [j(g) for g in grids], j(vals), obs, j(out)
    )
    r5 = getattr(raw, f"interpn_cubic_regular_{f}")(
        dims, j(starts), j(steps), j(vals), True, obs, j(out)
    )
    r6 = getattr(raw, f"interpn_cubic_rectilinear_{f}")(
        [j(g) for g in grids], j(vals), False, obs, j(out)
    )
    for r in (r1, r2, r3, r4, r5, r6):
        assert np.all(np.isfinite(np.asarray(r)))
    # linear == its rectilinear twin on the identical grid
    np.testing.assert_allclose(np.asarray(r1), np.asarray(r2), rtol=1e-6)

    bout = np.zeros(2, bool)
    getattr(raw, f"check_bounds_regular_{f}")(
        dims, starts, steps, [np.asarray(o) for o in obs], 1e-8, bout
    )
    assert not bout.any()
    # device path of check_bounds (jax-array obs skips the native wrapper)
    r7 = getattr(raw, f"check_bounds_rectilinear_{f}")(
        [j(g) for g in grids],
        [o + 100.0 for o in obs],
        1e-8,
        j(np.zeros(2, bool)),
    )
    assert np.asarray(r7).all()


def test_raw_device_path_with_numpy_out_and_jax_obs():
    """jax obs + numpy out: result written back in place (_finish)."""
    x, vals = _grid2()
    obs = [jnp.linspace(0.0, 5.0, 32)] * 2
    out = np.zeros(32)
    r = raw.interpn_linear_regular_f64(
        [6, 6], np.zeros(2), np.ones(2), vals, obs, out
    )
    assert r is out and np.all(np.isfinite(out))


# ---------------------------------------------------------------------------
# validator failure branches, per class (reference messages)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "cls,rect",
    [
        (it.MultilinearRectilinear, True),
        (it.MulticubicRectilinear, True),
        (it.NearestRectilinear, True),
        (it.NearestRegular, False),
    ],
)
def test_every_rect_class_validation_branches(cls, rect):
    n = 5
    x = np.arange(float(n))
    vals = np.zeros(n * n)
    if rect:
        with pytest.raises(ValidationError, match="monotonically increasing"):
            cls.new([x[::-1].copy(), x], vals)
        with pytest.raises(ValidationError, match="does not match grid dims"):
            cls.new([x, x], np.zeros(7))
        from interpn_tpu.models.serialization import ArrayF32, ArrayF64

        kw = (
            {"linearize_extrapolation": True}
            if cls is it.MulticubicRectilinear
            else {}
        )
        with pytest.raises(ValidationError, match="same data type"):
            cls(
                grids=[
                    ArrayF32(data=x.astype(np.float32)),
                    ArrayF64(data=x),
                ],
                vals=ArrayF64(data=vals),
                **kw,
            )
    else:
        with pytest.raises(ValidationError, match="does not match grid dims"):
            cls.new([n, n], np.zeros(2), np.ones(2), np.zeros(7))


def test_class_device_eval_every_family(monkeypatch):
    """INTERPN_TPU_NATIVE=0 drives every class's _eval_device hook."""
    monkeypatch.setenv("INTERPN_TPU_NATIVE", "0")
    n = 6
    x = np.arange(float(n))
    rng = itesting.rng_fixed_seed(3)
    vals = rng.standard_normal(n * n)
    obs = [rng.uniform(0, n - 1.0, 40) for _ in range(2)]
    models = [
        it.MultilinearRegular.new([n, n], np.zeros(2), np.ones(2), vals),
        it.MulticubicRegular.new([n, n], np.zeros(2), np.ones(2), vals),
        it.NearestRegular.new([n, n], np.zeros(2), np.ones(2), vals),
        it.MultilinearRectilinear.new([x, x], vals),
        it.MulticubicRectilinear.new([x, x], vals),
        it.NearestRectilinear.new([x, x], vals),
    ]
    outs = [m.eval(obs) for m in models]
    for o in outs:
        assert np.all(np.isfinite(o))
    # regular == rectilinear twin per method on the identical grid
    for a, b in zip(outs[:3], outs[3:]):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    # check_bounds through both mixins' device fallback (jax-array obs)
    jobs = [jnp.asarray(o) + 100.0 for o in obs]
    assert models[0].check_bounds(jobs, 1e-8).all()
    assert models[3].check_bounds(jobs, 1e-8).all()


def test_class_f32_check_bounds_and_eval():
    n = 6
    x = np.arange(n, dtype=np.float32)
    vals = np.zeros((n, n), np.float32).ravel()
    m = it.NearestRectilinear.new([x, x], vals)
    obs = [np.linspace(0, 5, 16, dtype=np.float32)] * 2
    assert not m.check_bounds(obs, 1e-6).any()
    m2 = it.NearestRegular.new(
        [n, n], np.zeros(2, np.float32), np.ones(2, np.float32), vals
    )
    assert not m2.check_bounds(obs, 1e-6).any()
    assert np.array_equal(m.eval(obs), m2.eval(obs))


# ---------------------------------------------------------------------------
# native fallbacks
# ---------------------------------------------------------------------------


def test_ctypes_path_without_fastcall(monkeypatch):
    """With the C fast-call extension unavailable, the ctypes closures
    evaluate correctly (the slow half of _compose)."""
    monkeypatch.setattr(native, "_fastcall", None)
    monkeypatch.setattr(native, "_fastcall_tried", True)
    n = 6
    x = np.arange(float(n))
    rng = itesting.rng_fixed_seed(5)
    vals = rng.standard_normal(n * n)
    obs = [rng.uniform(0, 5, 32) for _ in range(2)]
    ref_models = [
        it.MultilinearRegular.new([n, n], np.zeros(2), np.ones(2), vals),
        it.MulticubicRegular.new([n, n], np.zeros(2), np.ones(2), vals),
        it.NearestRegular.new([n, n], np.zeros(2), np.ones(2), vals),
        it.MultilinearRectilinear.new([x, x], vals),
    ]
    for m in ref_models:
        out = np.zeros(32)
        r = m.eval(obs, out)
        assert r is out
        ref = m.eval_jax([jnp.asarray(o) for o in obs])
        np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-12, atol=1e-12)


def test_warm_native_closure_falls_through_on_mismatched_dtype():
    """A WARM model (native closure prepared) receiving mismatched-dtype
    obs must fall through the closure guard to the raising general path."""
    n = 6
    vals = np.zeros(n * n)
    m = it.MultilinearRegular.new([n, n], np.zeros(2), np.ones(2), vals)
    obs = [np.linspace(0, 5, 8)] * 2
    m.eval(obs, np.zeros(8))  # warm: _native now prepared
    assert m._native
    with pytest.raises(TypeError, match="expected a float64 array"):
        m.eval_unchecked([o.astype(np.float32) for o in obs], np.zeros(8))


# ---------------------------------------------------------------------------
# profiling + testing helpers
# ---------------------------------------------------------------------------


def test_device_timeit_and_trace(tmp_path):
    from interpn_tpu.utils import profiling

    stack = jnp.asarray(np.random.default_rng(0).uniform(0, 5, (3, 2, 256)))

    def kernel(obs):
        return raw._linear_regular(
            (6, 6), jnp.zeros(2), jnp.ones(2), jnp.zeros(36), obs
        )[0]

    dt = profiling.device_timeit(kernel, stack)
    assert dt > 0
    with profiling.trace(str(tmp_path / "tr")) as d:
        jax.block_until_ready(kernel(tuple(stack[0])))
    assert d
    hlo = profiling.compiled_hlo(lambda o: kernel(o), tuple(stack[0]))
    assert "fusion" in hlo or "ENTRY" in hlo


def test_device_kernel_time_raises_without_matching_events(tmp_path):
    from interpn_tpu.utils import profiling

    def fn():
        jax.block_until_ready(jnp.zeros(8) + 1.0)

    with pytest.raises(RuntimeError, match="no device event"):
        profiling.device_kernel_time(
            fn, match="no_such_kernel", log_dir=str(tmp_path / "ktrace")
        )


def test_testing_helpers():
    r1, r2 = itesting.rng_fixed_seed(), itesting.rng_fixed_seed()
    np.testing.assert_array_equal(
        itesting.randn(r1, 5), itesting.randn(r2, 5)
    )
    assert itesting.randn(r1, 4, np.float32).dtype == np.float32
    g = itesting.perturbed_monotonic_grid(r1, 0.0, 5.0, 9)
    assert np.all(np.diff(g) > 0)


# ---------------------------------------------------------------------------
# dispatch override fallbacks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["pallas", "fast", ""])
def test_impl_mode_rejects_unknown_value(monkeypatch, mode):
    """INTERPN_TPU_IMPL takes auto, gather or factorized; any other value
    (including the removed "pallas") is refused at trace time instead of
    silently running another engine."""
    from interpn_tpu.ops import dispatch

    monkeypatch.setenv("INTERPN_TPU_IMPL", mode)
    with pytest.raises(ValueError, match="INTERPN_TPU_IMPL"):
        dispatch.linear_regular(
            (4, 4), jnp.zeros(2), jnp.ones(2), jnp.zeros(16),
            (jnp.zeros(3), jnp.zeros(3)),
        )


def test_interpn_f32_all_method_arms():
    """interpn()'s f32 dispatch arms across methods and grid kinds."""
    n = 6
    x = np.arange(n, dtype=np.float32)
    xr = x.copy()
    xr[1] += 0.25  # breaks exact regularity -> rectilinear arms
    rng = itesting.rng_fixed_seed(9)
    vals = rng.standard_normal((n, n)).astype(np.float32)
    obs = [rng.uniform(0.5, 4.5, 33).astype(np.float32) for _ in range(2)]
    for grids in ([x, x], [xr, x]):
        for method in ("linear", "cubic", "nearest"):
            out = it.interpn(obs, grids, vals, method=method)
            assert out.dtype == np.float32 and np.all(np.isfinite(out))


def _forced_arm_case(n, seed):
    rng = itesting.rng_fixed_seed(seed)
    x = np.arange(float(n))
    vals64 = rng.standard_normal(n * n)
    nq = 2048
    obs64 = tuple(jnp.asarray(rng.uniform(0, n - 1.0, nq)) for _ in range(2))
    return x, vals64, obs64


def _family_calls(dims, x, vals, obs, dtype):
    st, sp = jnp.zeros(2, dtype), jnp.ones(2, dtype)
    g = (jnp.asarray(x, dtype),) * 2
    v = jnp.asarray(vals, dtype)
    ob = tuple(o.astype(dtype) for o in obs)
    from interpn_tpu.ops import dispatch

    return [
        lambda: dispatch.nearest_regular(dims, st, sp, v, ob),
        lambda: dispatch.nearest_rectilinear(g, v, ob),
        lambda: dispatch.linear_regular(dims, st, sp, v, ob),
        lambda: dispatch.linear_rectilinear(g, v, ob),
        lambda: dispatch.cubic_regular(dims, st, sp, v, ob, True),
        lambda: dispatch.cubic_rectilinear(g, v, ob, True),
    ]


def test_dispatch_forced_factorized_arms(monkeypatch):
    """Every family's forced factorized arm matches its auto (gather) arm:
    exactly for nearest, at dtype rounding for the contractions."""
    n = 20
    x, vals64, obs64 = _forced_arm_case(n, 13)
    for dtype, tol in ((jnp.float32, 1e-5), (jnp.float64, 1e-12)):
        calls = _family_calls((n, n), x, vals64, obs64, dtype)
        auto = [np.asarray(fn()) for fn in calls]
        monkeypatch.setenv("INTERPN_TPU_IMPL", "factorized")
        try:
            forced = [np.asarray(fn()) for fn in calls]
        finally:
            monkeypatch.delenv("INTERPN_TPU_IMPL")
        for i, (a, b) in enumerate(zip(forced, auto)):
            if i < 2:
                assert np.array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# interpn()/interpn_stack() residual branches (round 4): exactly-regular
# grids (linspace spacings are not bitwise equal, so most suites autodetect
# rectilinear and the regular arms stay dark), non-view out= buffers on the
# extension methods, and the terminal dispatch/validation errors.
# ---------------------------------------------------------------------------


def _exact_regular_setup(dtype=np.float64, n=8, nch=3, nobs=17):
    rng = itesting.rng_fixed_seed(5)
    x = np.arange(float(n), dtype=dtype)  # exactly regular spacings
    grids = [x, x]
    vals = rng.standard_normal((nch, n, n)).astype(dtype)
    obs = [
        rng.uniform(0.0, n - 1.0, nobs).astype(dtype),
        rng.uniform(0.0, n - 1.0, nobs).astype(dtype),
    ]
    return grids, vals, obs


@pytest.mark.parametrize("method", ["linear", "nearest", "cubic"])
def test_interpn_stack_regular_branch(method):
    grids, vals, obs = _exact_regular_setup()
    assert it._check_regular(grids)  # the arm under test
    got = it.interpn_stack(obs, grids, vals, method=method)
    for c in range(vals.shape[0]):
        ref = it.interpn(obs, grids, vals[c].ravel(), method=method)
        if method == "nearest":
            np.testing.assert_array_equal(got[c], ref)
        else:
            np.testing.assert_allclose(got[c], ref, rtol=1e-13, atol=1e-13)


def test_interpn_stack_pchip_regular_branch():
    grids, vals, obs = _exact_regular_setup()
    got = it.interpn_stack(obs, grids, vals, method="pchip")
    for c in range(vals.shape[0]):
        ref = it.interpn(obs, grids, vals[c].ravel(), method="pchip")
        np.testing.assert_allclose(got[c], ref, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("regular", [True, False])
def test_interpn_stack_check_bounds_arms(dtype, regular):
    grids, vals, obs = _exact_regular_setup(dtype=dtype)
    if not regular:
        grids = [g.copy() for g in grids]
        grids[0][1] += dtype(0.25)  # break exact regularity
    # in-bounds passes...
    got = it.interpn_stack(obs, grids, vals, check_bounds=True)
    assert got.shape == (vals.shape[0], obs[0].shape[0])
    # ...and a violating first axis raises the reference message
    bad = [np.full(4, 1e3, dtype=dtype), obs[1][:4].copy()]
    with pytest.raises(ValueError, match="violate interpolator bounds"):
        it.interpn_stack(bad, grids, vals, check_bounds=True)


def test_interpn_stack_obs_count_mismatch():
    grids, vals, obs = _exact_regular_setup()
    with pytest.raises(AssertionError, match="Dimension mismatch"):
        it.interpn_stack(obs + [obs[0]], grids, vals)


@pytest.mark.parametrize("regular", [True, False])
def test_interpn_stack_unsupported_method(regular):
    grids, vals, obs = _exact_regular_setup()
    if not regular:
        grids = [g.copy() for g in grids]
        grids[0][1] += 0.25
    with pytest.raises(ValueError, match="Unsupported method"):
        it.interpn_stack(obs, grids, vals, method="akima")


def test_interpn_nearest_f64_regular_arm():
    grids, vals, obs = _exact_regular_setup()
    got = it.interpn(obs, grids, vals[0].ravel(), method="nearest")
    ref = it.interpn(
        obs, [g + 0.0 for g in grids], vals[0].ravel(), method="nearest",
        assume_regular=True,
    )
    np.testing.assert_array_equal(got, ref)


def test_interpn_unsupported_configuration():
    grids, vals, obs = _exact_regular_setup()
    with pytest.raises(ValueError, match="Unsupported interpolation"):
        it.interpn(obs, grids, vals[0].ravel(), method="akima")


@pytest.mark.parametrize("method", ["pchip", "cubic_spline", "quintic"])
def test_interpn_extensions_non_view_out(method):
    """A non-contiguous out= raveling to a copy must still receive results
    (the fold-back branch of the in-place contract)."""
    grids, vals, obs = _exact_regular_setup()
    n = obs[0].shape[0]
    backing = np.zeros((n, 2))
    user_out = backing[:, 0::2].reshape(n)  # strided: ravel() copies
    assert user_out.base is not None
    res = it.interpn(obs, grids, vals[0].ravel(), method=method, out=user_out)
    ref = it.interpn(obs, grids, vals[0].ravel(), method=method)
    assert res is user_out
    np.testing.assert_allclose(np.asarray(user_out), ref, rtol=0, atol=0)


def test_dispatch_forced_factorized_nonfinite_table_runs_gather(monkeypatch):
    """A forced factorized call on a table holding inf still returns the
    gather tree's result (0 * inf would poison every query): queries whose
    stencil avoids the sentinel stay finite on every family arm."""
    n = 64
    x, vals64, obs64 = _forced_arm_case(n, 29)
    vals64[-1] = np.inf  # far corner; queries below sit away from it
    obs = tuple(o * 0.5 for o in obs64)
    calls = _family_calls((n, n), x, vals64, obs, jnp.float64)
    auto = [np.asarray(fn()) for fn in calls]
    monkeypatch.setenv("INTERPN_TPU_IMPL", "factorized")
    for fn, ref in zip(calls, auto):
        got = np.asarray(fn())
        assert np.isfinite(got).all()
        np.testing.assert_array_equal(got, ref)
