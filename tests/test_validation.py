"""Model-validation parity: the reference's exact assertion messages
(`src/interpn/*.py` model validators) and API edge behaviors."""

import numpy as np
import pytest
from pydantic import ValidationError

import interpn_tpu as it


def _msg(excinfo) -> str:
    return str(excinfo.value)


def test_ndims_ceiling_messages():
    with pytest.raises(ValidationError) as e:
        it.MultilinearRegular.new(
            [2] * 9, np.zeros(9), np.ones(9), np.zeros(2**9)
        )
    assert "Number of dimensions must be at least 1 and no more than 8" in _msg(e)

    with pytest.raises(ValidationError) as e:
        it.NearestRegular.new([2] * 7, np.zeros(7), np.ones(7), np.zeros(2**7))
    assert "Number of dimensions must be at least 1 and no more than 6" in _msg(e)


def test_grid_dimension_mismatch_message():
    with pytest.raises(ValidationError) as e:
        it.MultilinearRegular.new([4, 4], np.zeros(3), np.ones(2), np.zeros(16))
    assert "Grid dimension mismatch" in _msg(e)


def test_vals_size_message():
    with pytest.raises(ValidationError) as e:
        it.MultilinearRegular.new([4, 4], np.zeros(2), np.ones(2), np.zeros(15))
    assert "Size of value array does not match grid dims" in _msg(e)


def test_steps_positive_message():
    with pytest.raises(ValidationError) as e:
        it.MultilinearRegular.new(
            [4], np.zeros(1), np.array([-0.5]), np.zeros(4)
        )
    assert "All grid steps must be positive and nonzero" in _msg(e)


def test_rectilinear_monotonic_message():
    with pytest.raises(ValidationError) as e:
        it.MultilinearRectilinear.new([np.array([0.0, 2.0, 1.0])], np.zeros(3))
    assert "All grids must be monotonically increasing" in _msg(e)


def test_mixed_dtype_message():
    with pytest.raises(ValidationError) as e:
        it.MultilinearRectilinear(
            grids=[{"data": [0.0, 1.0], "dtype": "float32"}],
            vals={"data": [0.0, 1.0], "dtype": "float64"},
        )
    assert "same data type" in _msg(e)


def test_eval_allocates_like_obs_when_out_none():
    m = it.MultilinearRegular.new([5], np.zeros(1), np.ones(1), np.arange(5.0))
    obs = [np.linspace(0, 4, 7)]
    out = m.eval(obs)
    assert isinstance(out, np.ndarray)
    assert out.shape == obs[0].shape and out.dtype == obs[0].dtype
    np.testing.assert_allclose(out, obs[0], atol=1e-15)


def test_eval_unchecked_returns_out_buffer():
    m = it.MulticubicRegular.new([4], np.zeros(1), np.ones(1), np.arange(4.0))
    obs = [np.array([0.5, 3.5])]
    out = np.zeros(2)
    r = m.eval_unchecked(obs, out)
    assert r is out


def test_warmup_compiles_device_path():
    m = it.MultilinearRegular.new([5], np.zeros(1), np.ones(1), np.arange(5.0))
    m.warmup(64)  # should not raise; device path now cached
    import jax.numpy as jnp

    out = m.eval_jax((jnp.linspace(0.0, 4.0, 64),))
    assert out.shape == (64,)


def test_check_bounds_native_matches_device():
    m = it.MultilinearRegular.new(
        [5, 4], np.array([0.0, 10.0]), np.array([1.0, 2.0]), np.zeros(20)
    )
    obs = [np.array([-0.5, 2.0]), np.array([11.0, 12.0])]
    flags_native = m.check_bounds(obs, 1e-9)
    # force the device path
    import os

    os.environ["INTERPN_TPU_NATIVE"] = "0"
    try:
        flags_dev = m.check_bounds(obs, 1e-9)
    finally:
        del os.environ["INTERPN_TPU_NATIVE"]
    assert np.array_equal(flags_native, flags_dev)
    assert flags_native[0] and not flags_native[1]


class TestUnrepresentableCoordinates:
    """Reference parity: REGULAR-grid kernels cast the cell location to a
    signed 64-bit index and raise AssertionError("Unrepresentable coordinate
    value") for NaN/inf/out-of-range coordinates
    (`src/multilinear/regular.rs:418`, `src/multicubic/regular.rs:438`,
    `src/nearest/regular.rs:309`); RECTILINEAR kernels bisect instead of
    casting and silently propagate (`src/multilinear/rectilinear.rs:352-370`
    has no cast). Covers the native CPU path (small numpy batches), the
    device path (jax arrays), and both dtypes."""

    BADS = [np.nan, np.inf, -np.inf, 1e300]
    MSG = "Unrepresentable coordinate value"

    def _obs(self, bad, n=2):
        return [np.array([0.5, bad]), np.array([0.5, 0.5])][:n]

    @pytest.mark.parametrize("bad", BADS)
    @pytest.mark.parametrize("method", ["linear", "cubic", "nearest"])
    @pytest.mark.parametrize("dtype", [np.float64, np.float32])
    def test_raw_regular_raises(self, bad, method, dtype):
        if dtype == np.float32 and bad == 1e300:
            bad = 1e38  # representable in f32, floc still > 2^63
        dims = [5, 5]
        grid = np.linspace(0, 1, 5).astype(dtype)
        vals = np.arange(25, dtype=dtype)
        fn = getattr(
            it.raw,
            f"interpn_{method}_regular_{'f64' if dtype == np.float64 else 'f32'}",
        )
        obs = [o.astype(dtype) for o in self._obs(bad)]
        out = np.zeros(2, dtype=dtype)
        args = [dims, grid[:2] * 0, np.full(2, 0.25, dtype)]
        if method == "cubic":
            with pytest.raises(AssertionError, match=self.MSG):
                fn(*args, vals, True, obs, out)
        else:
            with pytest.raises(AssertionError, match=self.MSG):
                fn(*args, vals, obs, out)

    @pytest.mark.parametrize("method", ["linear", "cubic", "nearest"])
    def test_raw_rectilinear_propagates(self, method):
        grids = [np.linspace(0, 1, 5)] * 2
        vals = np.arange(25.0)
        fn = getattr(it.raw, f"interpn_{method}_rectilinear_f64")
        obs = self._obs(np.nan)
        out = np.zeros(2)
        if method == "cubic":
            fn(grids, vals, True, obs, out)
        else:
            fn(grids, vals, obs, out)
        assert out[0] == out[0]  # first point evaluated normally

    def test_class_native_path_raises(self):
        m = it.MultilinearRegular.new(
            [5, 5], np.zeros(2), np.full(2, 0.25), np.arange(25.0)
        )
        with pytest.raises(AssertionError, match=self.MSG):
            m.eval([np.array([np.nan]), np.array([0.5])])

    def test_class_device_path_raises(self):
        import jax.numpy as jnp

        m = it.MulticubicRegular.new(
            [5, 5], np.zeros(2), np.full(2, 0.25), np.arange(25.0)
        )
        with pytest.raises(AssertionError, match=self.MSG):
            m.eval_unchecked([jnp.full(4096, jnp.inf), jnp.full(4096, 0.5)])

    def test_eval_jax_propagates_not_raises(self):
        """Device-native API keeps async dispatch: NaN in, NaN out."""
        import jax.numpy as jnp

        m = it.MultilinearRegular.new(
            [5, 5], np.zeros(2), np.full(2, 0.25), np.arange(25.0)
        )
        out = np.asarray(m.eval_jax([jnp.full(8, jnp.nan), jnp.full(8, 0.5)]))
        assert np.isnan(out).all()

    def test_interpn_function_raises(self):
        grids = [np.linspace(0, 1, 5)] * 2
        with pytest.raises(AssertionError, match=self.MSG):
            it.interpn(self._obs(np.nan), grids, np.arange(25.0).reshape(5, 5))


class TestRawDtypeStrictness:
    """Reference parity: the monomorphized raw entry points refuse
    mismatched array dtypes and non-array inputs with TypeError (PyO3's
    `PyReadonlyArray1<T>` extraction, `src/python.rs:58-80`) instead of
    silently casting — an f32 entry fed f64 data would otherwise silently
    truncate."""

    def test_f32_entry_refuses_f64_arrays(self):
        vals = np.arange(16.0)
        obs = [np.full(3, 1.5), np.full(3, 2.5)]
        with pytest.raises(TypeError, match="expected a float32 array"):
            it.raw.interpn_linear_regular_f32(
                [4, 4], np.zeros(2), np.ones(2), vals, obs, np.zeros(3)
            )

    def test_f64_entry_refuses_f32_arrays(self):
        vals = np.arange(16.0, dtype=np.float32)
        obs = [np.full(3, 1.5, np.float32), np.full(3, 2.5, np.float32)]
        with pytest.raises(TypeError, match="expected a float64 array"):
            it.raw.interpn_linear_regular_f64(
                [4, 4], np.zeros(2, np.float32), np.ones(2, np.float32),
                vals, obs, np.zeros(3, np.float32),
            )

    def test_mixed_dtypes_refused(self):
        with pytest.raises(TypeError, match="argument 'vals'"):
            it.raw.interpn_linear_regular_f64(
                [4, 4], np.zeros(2), np.ones(2),
                np.arange(16.0, dtype=np.float32),
                [np.full(3, 1.5), np.full(3, 2.5)], np.zeros(3),
            )

    def test_list_inputs_refused(self):
        with pytest.raises(TypeError, match="argument 'starts'.*got list"):
            it.raw.interpn_linear_regular_f64(
                [4, 4], [0.0, 0.0], np.ones(2), np.arange(16.0),
                [np.full(3, 1.5), np.full(3, 2.5)], np.zeros(3),
            )

    def test_rectilinear_and_cubic_entries_check(self):
        g = [np.linspace(0, 1, 5, dtype=np.float32)] * 2
        vals = np.arange(25.0, dtype=np.float32)
        obs = [np.full(3, 0.5, np.float32)] * 2
        with pytest.raises(TypeError, match="argument 'out'"):
            it.raw.interpn_linear_rectilinear_f32(g, vals, obs, np.zeros(3))
        with pytest.raises(TypeError, match="argument 'grids'"):
            it.raw.interpn_cubic_rectilinear_f32(
                [gg.astype(np.float64) for gg in g], vals, True, obs,
                np.zeros(3, np.float32),
            )

    def test_check_bounds_out_must_be_bool(self):
        with pytest.raises(TypeError, match="argument 'out'.*expected a bool"):
            it.raw.check_bounds_regular_f64(
                [4], np.zeros(1), np.ones(1), [np.full(3, 0.5)], 1e-8,
                np.zeros(1),
            )

    def test_matching_dtypes_pass(self):
        out = np.zeros(3, np.float32)
        it.raw.interpn_linear_regular_f32(
            [4, 4], np.zeros(2, np.float32), np.ones(2, np.float32),
            np.arange(16.0, dtype=np.float32),
            [np.full(3, 1.5, np.float32), np.full(3, 2.5, np.float32)], out,
        )
        assert np.isfinite(out).all()


class TestClassDtypeStrictness:
    """Class-level parity with the raw layer's dtype refusal (ADVICE r2):
    the reference's classes hand obs straight to the monomorphized PyO3
    functions, so a float array of the other width raises TypeError at the
    class layer too — never a silent cast."""

    def _model(self, dtype):
        return it.MultilinearRegular.new(
            [4, 4], np.zeros(2, dtype), np.ones(2, dtype),
            np.arange(16, dtype=dtype),
        )

    def test_eval_refuses_other_width_obs(self):
        m64 = self._model(np.float64)
        obs32 = [np.linspace(0, 3, 7, dtype=np.float32)] * 2
        with pytest.raises(TypeError, match="expected a float64 array"):
            m64.eval(obs32, np.zeros(7))
        m32 = self._model(np.float32)
        obs64 = [np.linspace(0, 3, 7, dtype=np.float64)] * 2
        with pytest.raises(TypeError, match="expected a float32 array"):
            m32.eval(obs64, np.zeros(7, np.float32))

    def test_eval_refuses_other_width_out(self):
        m32 = self._model(np.float32)
        obs32 = [np.linspace(0, 3, 7, dtype=np.float32)] * 2
        with pytest.raises(TypeError, match="argument 'out'"):
            m32.eval_unchecked(obs32, np.zeros(7, np.float64))

    def test_matching_dtypes_and_list_obs_still_pass(self):
        m64 = self._model(np.float64)
        obs = [np.linspace(0, 3, 7)] * 2
        out = m64.eval(obs)
        assert out.dtype == np.float64
        # lists remain accepted (documented extension; converts to f64)
        out2 = m64.eval([list(o) for o in obs])
        np.testing.assert_allclose(out2, out, rtol=1e-15)


def test_check_bounds_ragged_obs_per_dimension():
    """check_bounds scans each dimension over ITS OWN length (reference
    `regular.rs:145-182`): ragged obs are legal there even though eval
    refuses them. The native kernel takes a single n, so it must fall back
    to the per-dimension JAX path rather than mis-scan (previously it read
    obs[1] for only len(obs[0]) elements — wrong flags, and an
    out-of-bounds read when obs[k] was SHORTER than obs[0])."""
    import interpn_tpu as it

    dims = [4, 4]
    starts, steps = np.zeros(2), np.ones(2)
    # obs[1] longer than obs[0], violation only in its tail
    obs = [np.zeros(1), np.array([0.5, 99.0])]
    out = np.zeros(2, dtype=bool)
    it.raw.check_bounds_regular_f64(dims, starts, steps, obs, 1e-6, out)
    assert list(out) == [False, True]
    # shorter second axis: no out-of-bounds read, correct flags
    obs = [np.array([0.5, 0.5, 99.0]), np.array([0.5])]
    out = np.zeros(2, dtype=bool)
    it.raw.check_bounds_regular_f64(dims, starts, steps, obs, 1e-6, out)
    assert list(out) == [True, False]
    grids = [np.arange(4.0), np.arange(4.0)]
    out = np.zeros(2, dtype=bool)
    it.raw.check_bounds_rectilinear_f64(
        grids, [np.zeros(1), np.array([0.5, 99.0])], 1e-6, out
    )
    assert list(out) == [False, True]


def test_rectilinear_nan_locates_like_reference():
    """partition_point(< NaN) = 0 in the reference and the native
    bisection; jnp.searchsorted sorts NaN last. Both dispatch paths must
    pick the LOW edge cell for a NaN coordinate (previously the JAX path
    returned the high-edge value — same entry point, different answers by
    batch size)."""
    import interpn_tpu as it

    grids = [np.array([0.0, 1.0, 2.0, 3.0])]
    vals = np.array([10.0, 20.0, 30.0, 40.0])
    for n in (1, 4096):  # native fast path vs JAX path
        obs = [np.full(n, np.nan)]
        out = np.zeros(n)
        it.raw.interpn_nearest_rectilinear_f64(grids, vals, obs, out)
        # loc 0, dt = NaN -> (dt <= 0.5) false -> offset 1 -> vals[1]
        assert out[0] == 20.0, (n, out[0])


def test_host_feature_tag_stable_and_keyed():
    """The host feature tag is stable within a process, hex, and part of
    the native library's file name, so a build copied from another host
    is rebuilt instead of loaded (a -march=native binary can SIGILL)."""
    from interpn_tpu import config, native

    tag = config.host_feature_tag()
    assert tag == config.host_feature_tag()
    assert len(tag) == 12 and int(tag, 16) >= 0
    assert native._lib_path().name.endswith(f"_{tag}.so")


def test_native_build_keyed_by_host_tag(monkeypatch):
    """Another host's tag names another library: the build made here is
    not the one that host would load."""
    from interpn_tpu import config, native

    here = native._lib_path()
    monkeypatch.setattr(config, "host_feature_tag", lambda: "0123456789ab")
    there = native._lib_path()
    assert there != here
    assert there.name.endswith("_0123456789ab.so")
    assert there.name.split("_")[2] == here.name.split("_")[2]  # same source hash


class _FakeJaxConfig:
    """Records jax.config.update calls; exposes jax_platforms like the real
    config object. Lets every _setup branch run in the CPU test process
    with zero global effect."""

    def __init__(self, platforms, fail=False):
        self.jax_platforms = platforms
        self.updates = {}
        self._fail = fail

    def update(self, k, v):
        if self._fail:
            raise RuntimeError("synthetic update failure")
        self.updates[k] = v


def _run_setup(monkeypatch, platforms, *, env=None, fail=False):
    import types

    from interpn_tpu import config

    fake = _FakeJaxConfig(platforms, fail=fail)
    monkeypatch.setattr(
        config, "jax", types.SimpleNamespace(config=fake, __version__="t")
    )
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("INTERPN_TPU_NO_X64", raising=False)
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    config._setup()
    return fake.updates


@pytest.mark.parametrize("case", ["variable_set", "unset", "cpu_pinned"])
def test_setup_cache_dir_rule(monkeypatch, tmp_path, case):
    """JAX_COMPILATION_CACHE_DIR set: the code sets no other cache (JAX
    reads the variable itself). Unset: the fixed in-checkout directory.
    A process pinned to the CPU: no persistent cache."""
    import os

    from interpn_tpu import config

    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if case == "variable_set" else None
    platforms = "cpu" if case == "cpu_pinned" else None
    updates = _run_setup(monkeypatch, platforms, env=env)
    assert updates["jax_enable_x64"] is True
    if case == "unset":
        d = updates["jax_compilation_cache_dir"]
        assert d == config.DEFAULT_CACHE_DIR
        repo = os.path.dirname(os.path.dirname(os.path.abspath(config.__file__)))
        assert d == os.path.join(repo, ".jax_cache")
        assert updates["jax_persistent_cache_min_compile_time_secs"] == 1.0
    else:
        assert "jax_compilation_cache_dir" not in updates


def test_setup_no_x64_opt_out(monkeypatch):
    updates = _run_setup(monkeypatch, None, env={"INTERPN_TPU_NO_X64": "1"})
    assert "jax_enable_x64" not in updates
    # cache setup still runs
    assert "jax_compilation_cache_dir" in updates


def test_setup_swallows_update_failure(monkeypatch):
    """An old jaxlib without the persistent-cache flags must not break
    import (_setup wraps the cache updates in try/except). The x64 toggle
    is NOT guarded (it predates every supported jaxlib), so opt out of it
    here to isolate the cache branch."""
    _run_setup(
        monkeypatch, None, env={"INTERPN_TPU_NO_X64": "1"}, fail=True
    )


def test_native_build_on_demand_recompiles():
    """Delete the cached shared library and prove the on-demand g++ build
    reproduces a loadable binary (built binaries are gitignored, so this
    test is what keeps the build real)."""
    import ctypes

    from interpn_tpu import native

    so = native._lib_path()
    backup = so.read_bytes() if so.exists() else None
    if so.exists():
        so.unlink()  # the already-loaded handle stays valid on Linux
    try:
        path = native._build()
        assert path is not None and path.exists(), "g++ rebuild failed"
        lib = ctypes.CDLL(str(path))
        assert lib is not None
    finally:
        if backup is not None and not so.exists():
            so.write_bytes(backup)
            so.chmod(0o755)
