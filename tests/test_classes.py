"""Four-API-level tests per interpolator class, in the style of the
reference's Python tests (`test/test_multilinear_regular.py:5-93` etc.):
raw binding, `interpn()` helper, wrapper class, and JSON round-trip, for both
f64 and f32."""

import numpy as np
import pytest

import interpn_tpu as it


def _approx(a, b, dtype, rtol64=1e-12, rtol32=1e-6):
    rtol = rtol64 if dtype == np.float64 else rtol32
    scale = max(1.0, float(np.max(np.abs(b))))
    np.testing.assert_allclose(a, b, atol=rtol * scale)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_multilinear_regular(dtype):
    x = np.linspace(0.0, 10.0, 5).astype(dtype)
    y = np.linspace(20.0, 30.0, 3).astype(dtype)
    xg, yg = np.meshgrid(x, y, indexing="ij")
    zg = (xg + 2.0 * yg).astype(dtype)
    dims = [x.size, y.size]
    starts = np.array([x[0], y[0]]).astype(dtype)
    steps = np.array([x[1] - x[0], y[1] - y[0]]).astype(dtype)
    obs = [xg.flatten(), yg.flatten()]
    zf = zg.flatten()

    out = np.zeros_like(zf)
    fn = (
        it.raw.interpn_linear_regular_f64
        if dtype == np.float64
        else it.raw.interpn_linear_regular_f32
    )
    fn(dims, starts, steps, zf, obs, out)
    assert np.array_equal(out, zf)  # exact at grid points

    out_helper = it.interpn(obs=obs, grids=[x, y], vals=zf, method="linear")
    assert np.array_equal(out_helper, zf)

    interp = it.MultilinearRegular.new(dims, starts, steps, zf)
    assert np.array_equal(interp.eval(obs), zf)

    inside = [np.array([5.0], dtype=dtype), np.array([25.0], dtype=dtype)]
    outside = [np.array([-5.0], dtype=dtype), np.array([-25.0], dtype=dtype)]
    assert not any(interp.check_bounds(inside, dtype(1e-6)))
    assert any(interp.check_bounds(outside, dtype(1e-6)))

    rt = it.MultilinearRegular.model_validate_json(interp.model_dump_json())
    assert np.array_equal(rt.eval(obs), zf)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_multilinear_rectilinear(dtype):
    x = np.array([0.0, 1.0, 2.5, 4.0, 8.0], dtype=dtype)
    y = np.array([20.0, 21.5, 30.0], dtype=dtype)
    xg, yg = np.meshgrid(x, y, indexing="ij")
    zg = (xg + 2.0 * yg).astype(dtype)
    obs = [xg.flatten(), yg.flatten()]
    zf = zg.flatten()

    out = np.zeros_like(zf)
    fn = (
        it.raw.interpn_linear_rectilinear_f64
        if dtype == np.float64
        else it.raw.interpn_linear_rectilinear_f32
    )
    fn([x, y], zf, obs, out)
    assert np.array_equal(out, zf)

    out_helper = it.interpn(obs=obs, grids=[x, y], vals=zf, method="linear")
    assert np.array_equal(out_helper, zf)

    interp = it.MultilinearRectilinear.new([x, y], zf)
    assert np.array_equal(interp.eval(obs), zf)

    assert not any(
        interp.check_bounds(
            [np.array([5.0], dtype=dtype), np.array([25.0], dtype=dtype)], 1e-6
        )
    )
    assert any(
        interp.check_bounds(
            [np.array([-5.0], dtype=dtype), np.array([25.0], dtype=dtype)], 1e-6
        )
    )

    rt = it.MultilinearRectilinear.model_validate_json(interp.model_dump_json())
    assert np.array_equal(rt.eval(obs), zf)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("linearize", [True, False])
def test_multicubic_regular(dtype, linearize):
    x = np.linspace(0.0, 10.0, 5).astype(dtype)
    y = np.linspace(20.0, 30.0, 4).astype(dtype)
    xg, yg = np.meshgrid(x, y, indexing="ij")
    zg = (2.0 * xg - yg).astype(dtype)
    dims = [x.size, y.size]
    starts = np.array([x[0], y[0]]).astype(dtype)
    steps = np.array([x[1] - x[0], y[1] - y[0]]).astype(dtype)
    obs = [xg.flatten(), yg.flatten()]
    zf = zg.flatten()

    out = np.zeros_like(zf)
    fn = (
        it.raw.interpn_cubic_regular_f64
        if dtype == np.float64
        else it.raw.interpn_cubic_regular_f32
    )
    fn(dims, starts, steps, zf, linearize, obs, out)
    _approx(out, zf, dtype)

    out_helper = it.interpn(
        obs=obs, grids=[x, y], vals=zf, method="cubic",
        linearize_extrapolation=linearize,
    )
    _approx(out_helper, zf, dtype)

    interp = it.MulticubicRegular.new(dims, starts, steps, zf, linearize)
    _approx(interp.eval(obs), zf, dtype)
    assert interp.linearize_extrapolation == linearize

    rt = it.MulticubicRegular.model_validate_json(interp.model_dump_json())
    _approx(rt.eval(obs), zf, dtype)
    assert rt.linearize_extrapolation == linearize


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_multicubic_rectilinear(dtype):
    x = np.array([0.0, 1.0, 2.5, 4.0, 8.0], dtype=dtype)
    y = np.array([20.0, 21.5, 24.0, 30.0], dtype=dtype)
    xg, yg = np.meshgrid(x, y, indexing="ij")
    zg = (2.0 * xg - yg).astype(dtype)
    obs = [xg.flatten(), yg.flatten()]
    zf = zg.flatten()

    out = np.zeros_like(zf)
    fn = (
        it.raw.interpn_cubic_rectilinear_f64
        if dtype == np.float64
        else it.raw.interpn_cubic_rectilinear_f32
    )
    fn([x, y], zf, True, obs, out)
    _approx(out, zf, dtype)

    interp = it.MulticubicRectilinear.new([x, y], zf)
    _approx(interp.eval(obs), zf, dtype)

    rt = it.MulticubicRectilinear.model_validate_json(interp.model_dump_json())
    _approx(rt.eval(obs), zf, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_nearest_regular(dtype):
    x = np.linspace(0.0, 10.0, 5).astype(dtype)
    y = np.linspace(20.0, 30.0, 3).astype(dtype)
    xg, yg = np.meshgrid(x, y, indexing="ij")
    zg = (xg + 2.0 * yg).astype(dtype)
    dims = [x.size, y.size]
    starts = np.array([x[0], y[0]]).astype(dtype)
    steps = np.array([x[1] - x[0], y[1] - y[0]]).astype(dtype)
    obs = [xg.flatten(), yg.flatten()]
    zf = zg.flatten()

    out = np.zeros_like(zf)
    fn = (
        it.raw.interpn_nearest_regular_f64
        if dtype == np.float64
        else it.raw.interpn_nearest_regular_f32
    )
    fn(dims, starts, steps, zf, obs, out)
    assert np.array_equal(out, zf)

    interp = it.NearestRegular.new(dims, starts, steps, zf)
    assert np.array_equal(interp.eval(obs), zf)

    rt = it.NearestRegular.model_validate_json(interp.model_dump_json())
    assert np.array_equal(rt.eval(obs), zf)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_nearest_rectilinear(dtype):
    x = np.array([0.0, 1.0, 2.5, 4.0, 8.0], dtype=dtype)
    y = np.array([20.0, 21.5, 30.0], dtype=dtype)
    xg, yg = np.meshgrid(x, y, indexing="ij")
    zg = (xg + 2.0 * yg).astype(dtype)
    obs = [xg.flatten(), yg.flatten()]
    zf = zg.flatten()

    out = np.zeros_like(zf)
    fn = (
        it.raw.interpn_nearest_rectilinear_f64
        if dtype == np.float64
        else it.raw.interpn_nearest_rectilinear_f32
    )
    fn([x, y], zf, obs, out)
    assert np.array_equal(out, zf)

    interp = it.NearestRectilinear.new([x, y], zf)
    assert np.array_equal(interp.eval(obs), zf)

    rt = it.NearestRectilinear.model_validate_json(interp.model_dump_json())
    assert np.array_equal(rt.eval(obs), zf)


def test_eval_jax_device_path():
    """Extension: device-array obs in, device array out, no numpy
    round trip."""
    import jax
    import jax.numpy as jnp

    x = np.linspace(0.0, 10.0, 5)
    vals = x * 3.0
    m = it.MultilinearRegular.new([5], np.array([0.0]), np.array([2.5]), vals)
    obs = (jnp.asarray(np.linspace(-1.0, 11.0, 7)),)
    out = m.eval_jax(obs)
    assert isinstance(out, jax.Array)
    np.testing.assert_allclose(np.asarray(out), np.asarray(obs[0]) * 3.0, atol=1e-12)


def test_eval_jax_first_call_under_jit_does_not_poison_cache():
    """A user's first eval_jax call may happen inside their own jit; the
    device-constant cache must not capture trace-local tracers (doing so
    made every subsequent call raise UnexpectedTracerError)."""
    import jax
    import jax.numpy as jnp

    x = np.linspace(0.0, 4.0, 5)
    m = it.MultilinearRegular.new([5], np.zeros(1), np.ones(1), 2.0 * x)
    obs = (jnp.asarray([1.5, 2.5]),)

    @jax.jit
    def f(ob):
        return m.eval_jax(ob)

    np.testing.assert_allclose(np.asarray(f(obs)), [3.0, 5.0])
    # eager call afterwards must work and may now populate the cache
    np.testing.assert_allclose(np.asarray(m.eval_jax(obs)), [3.0, 5.0])
    np.testing.assert_allclose(np.asarray(f(obs)), [3.0, 5.0])


def test_undersized_grid_raises_at_eval_not_construction():
    """Reference parity: the pydantic validators accept under-sized grids
    (the reference's do too — `multilinear_regular.py:73-96` has no
    per-axis size floor) and the EVAL path raises the core's exact message
    (`src/multilinear/regular.rs:243-245`, `src/multicubic/regular.rs:261`,
    `src/nearest/rectilinear.rs:141`). Previously the class eval path
    skipped this and returned uninitialized garbage via the native engine."""
    import pytest

    cases = [
        (
            it.MultilinearRegular.new([1], np.zeros(1), np.ones(1), np.zeros(1)),
            "All grids must have at least two entries",
        ),
        (
            it.MultilinearRectilinear.new([np.array([0.0])], np.zeros(1)),
            "All grids must have at least 2 entries",
        ),
        (
            it.MulticubicRegular.new([3, 3], np.zeros(2), np.ones(2), np.zeros(9)),
            "All grids must have at least four entries",
        ),
        (
            it.MulticubicRectilinear.new(
                [np.array([0.0, 1.0, 2.0])], np.zeros(3)
            ),
            "All grids must have at least 4 entries",
        ),
        (
            it.NearestRegular.new([1], np.zeros(1), np.ones(1), np.zeros(1)),
            "All grids must have at least two entries",
        ),
        (
            it.NearestRectilinear.new([np.array([0.0])], np.zeros(1)),
            "All grids must have at least 2 entries",
        ),
    ]
    for model, msg in cases:
        obs = [np.array([0.5])] * model.ndims()
        for meth in ("eval", "eval_unchecked", "eval_jax"):
            with pytest.raises(AssertionError, match=f"^{msg}$"):
                getattr(model, meth)(obs)


def test_undersized_grid_raises_in_gradient_jax():
    """gradient_jax shares the eval-time size floor (review finding: it
    previously skipped the guard and differentiated an invalid stencil)."""
    import pytest

    m = it.MulticubicRegular.new([3, 3], np.zeros(2), np.ones(2), np.zeros(9))
    with pytest.raises(
        AssertionError, match="^All grids must have at least four entries$"
    ):
        m.gradient_jax([np.array([0.5]), np.array([0.5])])


def test_mismatched_obs_and_out_sizes_raise():
    """Reference parity (`src/multilinear/regular.rs:257-266`): mismatched
    observation-array lengths or a wrong-size `out` raise "Dimension
    mismatch". Previously the native ctypes path truncated to out.size
    silently and a short obs array was read out of bounds."""
    import pytest

    m = it.MultilinearRegular.new(
        [5, 5], np.zeros(2), np.full(2, 0.25), np.arange(25.0)
    )
    obs = [np.full(10, 0.5), np.full(10, 0.5)]
    with pytest.raises(AssertionError, match="^Dimension mismatch$"):
        m.eval(obs, np.zeros(7))
    with pytest.raises(AssertionError, match="^Dimension mismatch$"):
        m.eval([np.full(10, 0.5), np.full(9, 0.5)])
    with pytest.raises(AssertionError, match="^Dimension mismatch$"):
        m.eval([np.full(10, 0.5)])  # too few obs arrays
    with pytest.raises(AssertionError, match="^Dimension mismatch$"):
        m.eval(obs + [np.full(10, 0.5)])  # too many
    with pytest.raises(AssertionError, match="^Dimension mismatch$"):
        m.eval_jax([np.full(10, 0.5), np.full(9, 0.5)])
    # matching sizes still work through all paths
    out = np.zeros(10)
    assert m.eval(obs, out) is out


def test_models_pickle_after_eval():
    """Reference parity: the pure-data pydantic models pickle at any point
    in their lifecycle. The lazily-built caches (device constants, native
    ctypes closure) are excluded from the pickled state and rebuilt on
    first use (previously: AttributeError "Can't get local object
    '_compose.<locals>.call'" once eval had populated the cache)."""
    import copy
    import pickle

    m = it.MulticubicRegular.new(
        [5, 5], np.zeros(2), np.full(2, 0.25), np.arange(25.0)
    )
    obs = [np.array([0.6]), np.array([0.7])]
    expect = m.eval(obs)  # populates native + device caches
    m.eval_jax(obs)
    for clone in (pickle.loads(pickle.dumps(m)), copy.deepcopy(m)):
        np.testing.assert_allclose(clone.eval(obs), expect)
        assert clone.model_dump_json() == m.model_dump_json()


def test_f32_model_accepts_list_observations():
    """eval() on a float32 model with plain-list observations: the
    internally-allocated out array must be model-dtype (zeros_like on a
    list produced float64 and tripped the strict out-dtype parity check
    for an array the user never passed)."""
    m = it.MultilinearRegular.new(
        [5, 5], np.zeros(2, np.float32), np.full(2, 0.25, np.float32),
        np.arange(25.0, dtype=np.float32),
    )
    out = m.eval([[0.5, 0.6], [0.5, 0.6]])
    assert out.dtype == np.float32
    assert out.shape == (2,)
    assert np.all(np.isfinite(out))
    out_u = m.eval_unchecked([[0.5, 0.6], [0.5, 0.6]])
    assert out_u.dtype == np.float32
    # explicit arrays of the WRONG width still raise (reference parity)
    with pytest.raises(TypeError):
        m.eval([np.full(2, 0.5), np.full(2, 0.5)])  # float64 obs


def test_native_disabled_is_not_memoized_as_unavailable(monkeypatch):
    """INTERPN_TPU_NATIVE=0 must not bake 'native unavailable' into a
    model: the build is skipped while disabled (no g++ spawn for a
    backend that dispatch will never consult), and flipping the env back
    on retries the preparation."""
    from interpn_tpu import native

    m = it.MultilinearRegular.new(
        [5, 5], np.zeros(2), np.full(2, 0.25), np.arange(25.0)
    )
    obs = [np.array([0.6]), np.array([0.7])]
    monkeypatch.setattr(native, "load_deferred", lambda: True)
    monkeypatch.setattr(
        type(m), "_prepare_native", lambda self: None, raising=True
    )
    expect = m.eval(obs)  # device path; prep declined but deferred
    assert m._native is None  # NOT memoized to False
    monkeypatch.undo()
    np.testing.assert_allclose(m.eval(obs), expect)  # retries for real
    assert m._native is not None
