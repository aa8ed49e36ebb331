"""Multi-device tests on the virtual 8-device CPU mesh (SURVEY.md §4.3):
sharded evaluation must match single-device results exactly, keep outputs
sharded along the obs axis, and compile to collective-free HLO."""

import jax
import numpy as np
import pytest

import interpn_tpu as it
from interpn_tpu import parallel

COLLECTIVES = (
    "all-reduce",
    "all-gather",
    "collective-permute",
    "reduce-scatter",
    "all-to-all",
)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest should configure 8 CPU devices"
    return parallel.make_mesh()


def _grid3(n=8):
    x = np.linspace(0.0, 10.0, n)
    xg, yg, zg = np.meshgrid(x, x, x, indexing="ij")
    vals = np.sin(xg) + yg * zg
    return x, vals.ravel()


@pytest.mark.parametrize("method", ["linear", "cubic", "nearest"])
def test_sharded_matches_single_device(mesh, method):
    x, vals = _grid3()
    rng = np.random.default_rng(99)
    n = 4096
    obs = tuple(rng.uniform(-2.0, 12.0, n) for _ in range(3))
    starts = np.zeros(3)
    steps = np.full(3, x[1] - x[0])

    f = parallel.sharded_evaluator(mesh, method=method, regular=True)
    obs_sh = parallel.shard_obs(obs, mesh)
    out_sharded = np.asarray(f((starts, steps), vals, obs_sh, dims=(8, 8, 8)))

    # single-device reference through the jit-compiled device cores (the raw
    # API now routes host data to the native CPU backend, which agrees only
    # to the last ulp — this test asserts exact sharded-vs-unsharded device
    # equality, so compare device-to-device)
    import jax.numpy as jnp

    obs_j = tuple(jnp.asarray(o) for o in obs)
    single_fn = {
        "linear": lambda: it.raw._linear_regular(
            (8, 8, 8), jnp.asarray(starts), jnp.asarray(steps), jnp.asarray(vals), obs_j
        ),
        "cubic": lambda: it.raw._cubic_regular(
            (8, 8, 8), jnp.asarray(starts), jnp.asarray(steps), jnp.asarray(vals),
            obs_j, True,
        ),
        "nearest": lambda: it.raw._nearest_regular(
            (8, 8, 8), jnp.asarray(starts), jnp.asarray(steps), jnp.asarray(vals), obs_j
        ),
    }[method]
    out_single = np.asarray(single_fn()[0])
    assert np.array_equal(out_sharded, out_single)


def test_output_sharding_and_no_collectives(mesh):
    x, vals = _grid3()
    rng = np.random.default_rng(7)
    obs = tuple(rng.uniform(0, 10, 4096) for _ in range(3))
    starts = np.zeros(3)
    steps = np.full(3, x[1] - x[0])

    f = parallel.sharded_evaluator(mesh, method="cubic", regular=True)
    obs_sh = parallel.shard_obs(obs, mesh)
    out = f((starts, steps), vals, obs_sh, dims=(8, 8, 8))
    assert len(out.addressable_shards) == 8
    assert out.sharding.spec == jax.sharding.PartitionSpec("obs")

    hlo = f.lower((starts, steps), vals, obs_sh, dims=(8, 8, 8)).compile().as_text()
    assert not any(op in hlo for op in COLLECTIVES)


def test_rectilinear_sharded(mesh):
    g = np.array([0.0, 0.5, 2.0, 3.5, 4.0, 7.0, 10.0])
    gg = np.meshgrid(g, g, indexing="ij")
    vals = (gg[0] * 2 - gg[1]).ravel()
    rng = np.random.default_rng(3)
    obs = tuple(rng.uniform(-1, 11, 1024) for _ in range(2))

    f = parallel.sharded_evaluator(mesh, method="linear", regular=False)
    obs_sh = parallel.shard_obs(obs, mesh)
    out = np.asarray(f((g, g), vals, obs_sh))
    np.testing.assert_allclose(out, obs[0] * 2 - obs[1], atol=1e-12)


def test_pad_to_multiple():
    x = np.arange(10.0)
    padded, n = parallel.pad_to_multiple(x, 8)
    assert padded.shape[0] == 16 and n == 10
    assert np.all(padded[10:] == x[-1])
    same, n2 = parallel.pad_to_multiple(np.arange(16.0), 8)
    assert same.shape[0] == 16 and n2 == 16


def test_factorized_sharded_no_collectives(mesh, monkeypatch):
    """The factorized implementation must also compile collective-free when
    queries are sharded (it is the forced engine)."""
    monkeypatch.setenv("INTERPN_TPU_IMPL", "factorized")
    x, vals = _grid3()
    rng = np.random.default_rng(11)
    obs = tuple(rng.uniform(0, 10, 4096) for _ in range(3))
    starts = np.zeros(3)
    steps = np.full(3, x[1] - x[0])

    f = parallel.sharded_evaluator(mesh, method="cubic", regular=True)
    obs_sh = parallel.shard_obs(obs, mesh)
    out = f((starts, steps), vals, obs_sh, dims=(8, 8, 8))
    assert out.sharding.spec == jax.sharding.PartitionSpec("obs")
    hlo = f.lower((starts, steps), vals, obs_sh, dims=(8, 8, 8)).compile().as_text()
    assert not any(op in hlo for op in COLLECTIVES)

    # and it matches the gather implementation
    monkeypatch.setenv("INTERPN_TPU_IMPL", "gather")
    g = parallel.sharded_evaluator(mesh, method="cubic", regular=True)
    out_g = g((starts, steps), vals, obs_sh, dims=(8, 8, 8))
    np.testing.assert_allclose(np.asarray(out), np.asarray(out_g), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("method", ["linear", "cubic", "nearest"])
@pytest.mark.parametrize("regular", [True, False])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_all_families_sharded_match_unsharded(mesh, method, regular, dtype):
    """Round 3 (VERDICT r2 weak #1): every method x grid-kind x dtype family
    evaluates sharded to ulp-level agreement with the unsharded device
    result (XLA fuses/contracts differently per shard shape, so bitwise
    equality is not guaranteed across every family) and collective-free
    HLO — including the previously-untested rectilinear cubic/nearest."""
    x, vals = _grid3()
    rng = np.random.default_rng(17)
    n = 2048
    obs = tuple(rng.uniform(-2.0, 12.0, n).astype(dtype) for _ in range(3))
    vals = vals.astype(dtype)
    garrs = (
        (np.zeros(3, dtype), np.full(3, x[1] - x[0], dtype))
        if regular
        else tuple(x.astype(dtype) for _ in range(3))
    )

    f = parallel.sharded_evaluator(mesh, method=method, regular=regular)
    obs_sh = parallel.shard_obs(obs, mesh)
    out = f(garrs, vals, obs_sh, dims=(8, 8, 8))
    assert out.sharding.spec == jax.sharding.PartitionSpec("obs")
    hlo = f.lower(garrs, vals, obs_sh, dims=(8, 8, 8)).compile().as_text()
    assert not any(op in hlo for op in COLLECTIVES)

    import jax.numpy as jnp

    from interpn_tpu import ops

    obs_j = tuple(jnp.asarray(o) for o in obs)
    if regular:
        single = {
            "linear": lambda: ops.linear_regular(
                (8, 8, 8), jnp.asarray(garrs[0]), jnp.asarray(garrs[1]),
                jnp.asarray(vals), obs_j,
            ),
            "cubic": lambda: ops.cubic_regular(
                (8, 8, 8), jnp.asarray(garrs[0]), jnp.asarray(garrs[1]),
                jnp.asarray(vals), obs_j, True,
            ),
            "nearest": lambda: ops.nearest_regular(
                (8, 8, 8), jnp.asarray(garrs[0]), jnp.asarray(garrs[1]),
                jnp.asarray(vals), obs_j,
            ),
        }[method]()
    else:
        gj = tuple(jnp.asarray(g) for g in garrs)
        single = {
            "linear": lambda: ops.linear_rectilinear(gj, jnp.asarray(vals), obs_j),
            "cubic": lambda: ops.cubic_rectilinear(gj, jnp.asarray(vals), obs_j, True),
            "nearest": lambda: ops.nearest_rectilinear(gj, jnp.asarray(vals), obs_j),
        }[method]()
    if method == "nearest":
        # pure selection: must be bitwise
        assert np.array_equal(np.asarray(out), np.asarray(single))
    else:
        rtol = 2e-15 if dtype == np.float64 else 2e-6
        np.testing.assert_allclose(
            np.asarray(out), np.asarray(single), rtol=rtol, atol=rtol * 100
        )


def test_nondivisible_batch_through_pad_to_multiple(mesh):
    """A batch length not divisible by the mesh, padded and sliced — the
    full user recipe, not just the pad helper in isolation."""
    x, vals = _grid3()
    rng = np.random.default_rng(23)
    n = 8 * 300 + 3
    obs = tuple(rng.uniform(0.0, 10.0, n) for _ in range(3))
    padded = [parallel.pad_to_multiple(o, 8) for o in obs]
    assert padded[0][0].shape[0] % 8 == 0 and padded[0][1] == n
    obs_sh = parallel.shard_obs(tuple(p for p, _ in padded), mesh)
    f = parallel.sharded_evaluator(mesh, method="cubic", regular=True)
    out = np.asarray(
        f((np.zeros(3), np.full(3, x[1] - x[0])), vals, obs_sh, dims=(8, 8, 8))
    )[:n]
    ref = np.asarray(
        f(
            (np.zeros(3), np.full(3, x[1] - x[0])),
            vals,
            parallel.shard_obs(
                tuple(np.pad(o, (0, 5), mode="edge") for o in obs), mesh
            ),
            dims=(8, 8, 8),
        )
    )[:n]
    np.testing.assert_array_equal(out, ref)


def test_f64_cubic_sharded_matches_oracle(mesh):
    """Sharded f64 cubic (with extrapolation) agrees with the independent
    numpy oracle at the f64 bar on a subsample."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent))
    import oracle

    x, vals = _grid3()
    rng = np.random.default_rng(29)
    n = 8192
    obs = tuple(rng.uniform(-2.0, 12.0, n) for _ in range(3))
    starts, steps = np.zeros(3), np.full(3, x[1] - x[0])
    f = parallel.sharded_evaluator(mesh, method="cubic", regular=True)
    out = np.asarray(f((starts, steps), vals, parallel.shard_obs(obs, mesh), dims=(8, 8, 8)))
    sel = rng.integers(0, n, 64)
    ref = np.array([
        oracle.cubic_regular([8, 8, 8], starts, steps, vals, [o[i] for o in obs], True)
        for i in sel
    ])
    np.testing.assert_allclose(out[sel], ref, rtol=0, atol=1e-12 * np.abs(vals).max())


def test_rectilinear_f32_sharded_reproduces_plane(mesh):
    """Rectilinear f32 linear evaluates per shard and reproduces a plane."""
    g = np.array([0.0, 0.5, 2.0, 3.5, 4.0, 7.0, 10.0, 11.0], np.float32)
    gg = np.meshgrid(g, g, indexing="ij")
    vals = (gg[0] * 2 - gg[1]).ravel().astype(np.float32)
    rng = np.random.default_rng(31)
    n = 16384
    obs = tuple(rng.uniform(0, 11, n).astype(np.float32) for _ in range(2))

    f = parallel.sharded_evaluator(mesh, method="linear", regular=False)
    obs_sh = parallel.shard_obs(obs, mesh)
    out = np.asarray(f((g, g), vals, obs_sh))
    np.testing.assert_allclose(out, obs[0] * 2 - obs[1], rtol=1e-5, atol=1e-4)


class TestPreparedEvaluator:
    """prepared_evaluator for the reference methods: the table is closed
    over at build time and the result equals sharded_evaluator's."""

    @staticmethod
    def _case(n=8192, seed=7, lo=0.0, hi=9.5):
        x = np.linspace(0.0, 10.0, 20)
        xg, yg, zg = np.meshgrid(x, x, x, indexing="ij")
        vals = np.sin(xg) + yg * zg
        rng = np.random.default_rng(seed)
        obs = tuple(rng.uniform(lo, hi, n) for _ in range(3))
        return x, vals.ravel(), np.zeros(3), np.full(3, x[1] - x[0]), obs

    def test_matches_sharded_evaluator(self, mesh):
        x, vals, starts, steps, obs = self._case()
        f = parallel.prepared_evaluator(
            mesh, (starts, steps), vals, dims=(20, 20, 20), method="cubic"
        )
        obs_sh = parallel.shard_obs(obs, mesh)
        out = np.asarray(f(obs_sh))
        g = parallel.sharded_evaluator(mesh, method="cubic", regular=True)
        ref = np.asarray(g((starts, steps), vals, obs_sh, dims=(20, 20, 20)))
        np.testing.assert_array_equal(out, ref)

    def test_rectilinear_and_output_sharding(self, mesh):
        rng = np.random.default_rng(11)
        g1 = np.sort(rng.uniform(0, 10, 20))
        g1[0], g1[-1] = 0.0, 10.0
        gg = np.meshgrid(g1, g1, g1, indexing="ij")
        vals = (np.sin(gg[0]) + gg[1] * gg[2]).ravel()
        obs = tuple(rng.uniform(0.5, 9.5, 8192) for _ in range(3))
        f = parallel.prepared_evaluator(
            mesh, (g1, g1, g1), vals, method="cubic", regular=False
        )
        obs_sh = parallel.shard_obs(obs, mesh)
        out = f(obs_sh)
        assert len(out.addressable_shards) == 8
        assert out.sharding.spec == jax.sharding.PartitionSpec("obs")
        ref_f = parallel.sharded_evaluator(mesh, method="cubic", regular=False)
        ref = np.asarray(ref_f((g1, g1, g1), vals, obs_sh))
        np.testing.assert_array_equal(np.asarray(out), ref)

    def test_f32_and_deep_extrapolation(self, mesh):
        """f32 tables and deep non-linearized cubic extrapolation evaluate
        like the generic sharded evaluator."""
        x, vals, starts, steps, obs = self._case()
        s32, p32 = starts.astype(np.float32), steps.astype(np.float32)
        f32 = parallel.prepared_evaluator(
            mesh, (s32, p32), vals.astype(np.float32), dims=(20, 20, 20),
            method="cubic",
        )
        o32 = parallel.shard_obs(tuple(o.astype(np.float32) for o in obs), mesh)
        g = parallel.sharded_evaluator(mesh, method="cubic", regular=True)
        np.testing.assert_array_equal(
            np.asarray(f32(o32)),
            np.asarray(g((s32, p32), vals.astype(np.float32), o32, dims=(20, 20, 20))),
        )

        f = parallel.prepared_evaluator(
            mesh, (starts, steps), vals, dims=(20, 20, 20), method="cubic",
            linearize_extrapolation=False,
        )
        deep = parallel.shard_obs(
            tuple(np.full(8192, 10.0 + 3.5 * (x[1] - x[0])) for _ in range(3)), mesh
        )
        gd = parallel.sharded_evaluator(
            mesh, method="cubic", regular=True, linearize_extrapolation=False
        )
        np.testing.assert_array_equal(
            np.asarray(f(deep)),
            np.asarray(gd((starts, steps), vals, deep, dims=(20, 20, 20))),
        )

    def test_regular_requires_dims(self, mesh):
        """regular=True with dims omitted must fail with a clear message,
        not an opaque iteration TypeError (grid_arrays is (starts, steps))."""
        x, vals, starts, steps, obs = self._case()
        with pytest.raises(TypeError, match="requires dims="):
            parallel.prepared_evaluator(mesh, (starts, steps), vals, method="cubic")


class TestPreparedExtensions:
    """Sharded evaluation for the extension methods (round 4): pchip and the
    global splines ride prepared_evaluator (host prep hoisted to build time,
    coefficient state replicated, obs/output sharded, zero collectives)."""

    @staticmethod
    def _case(n=8192, seed=11):
        x = np.linspace(0.0, 10.0, 12)
        xg, yg = np.meshgrid(x, x, indexing="ij")
        vals = np.sin(xg) + 0.3 * yg**2
        rng = np.random.default_rng(seed)
        obs = tuple(rng.uniform(0.0, 10.0, n) for _ in range(2))
        return x, vals.ravel(), obs

    @pytest.mark.parametrize("method", ["pchip", "cubic_spline", "quintic"])
    @pytest.mark.parametrize("regular", [True, False])
    def test_matches_single_chip(self, mesh, method, regular):
        import interpn_tpu

        x, vals, obs = self._case()
        if regular:
            x = np.arange(12.0)  # integer spacing: exactly regular
            obs = tuple(o * 1.1 for o in obs)
        f = parallel.prepared_evaluator(
            mesh,
            (np.zeros(2), np.ones(2)) if regular else (x, x),
            vals,
            dims=(12, 12) if regular else None,
            method=method,
            regular=regular,
        )
        obs_sh = parallel.shard_obs(obs, mesh)
        out = np.asarray(f(obs_sh))
        ref = interpn_tpu.interpn(
            [np.asarray(o) for o in obs], [x, x], vals, method=method
        )
        np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-12)

    def test_output_sharding_and_no_collectives(self, mesh):
        import re

        x, vals, obs = self._case()
        f = parallel.prepared_evaluator(
            mesh, (x, x), vals, method="cubic_spline", regular=False
        )
        obs_sh = parallel.shard_obs(obs, mesh)
        out = f(obs_sh)
        assert out.sharding.spec == jax.sharding.PartitionSpec("obs")
        assert len(out.sharding.device_set) == len(mesh.devices.ravel())

        jf = jax.jit(f)
        hlo = jf.lower(obs_sh).compile().as_text()
        assert not re.findall(
            r"all-reduce|all-gather|collective-permute|reduce-scatter|all-to-all",
            hlo,
        )

    def test_grid_floor(self, mesh):
        x = np.linspace(0.0, 1.0, 5)
        vals = np.zeros(25)
        with pytest.raises(AssertionError, match="at least 6 entries"):
            parallel.prepared_evaluator(
                mesh, (x, x), vals, method="quintic", regular=False
            )

    @pytest.mark.parametrize("method", ["pchip", "cubic_spline"])
    def test_table_size_mismatch(self, mesh, method):
        """A wrong-size table must raise the reference-style message at
        build time, not an opaque reshape error inside shard_map
        (ADVICE r4)."""
        x, vals, obs = self._case()
        with pytest.raises(AssertionError, match="Dimension mismatch"):
            parallel.prepared_evaluator(
                mesh, (x, x), vals[:-1], method=method, regular=False
            )


class TestPreparedStackEvaluator:
    """Sharded multi-channel evaluation: prepared_stack_evaluator must match
    interpn_stack per channel, keep (nch, obs) output sharding, and stay
    collective-free."""

    @staticmethod
    def _case(nch=3, n=8192, seed=13):
        x = np.arange(12.0)  # exactly regular
        xg, yg = np.meshgrid(x, x, indexing="ij")
        rng = np.random.default_rng(seed)
        vals = np.stack(
            [np.sin(xg + c) + 0.3 * yg**2 for c in range(nch)]
        ).reshape(nch, -1)
        obs = tuple(rng.uniform(0.0, 11.0, n) for _ in range(2))
        return x, vals, obs

    @pytest.mark.parametrize(
        "method",
        ["linear", "cubic", "nearest", "pchip", "cubic_spline", "quintic"],
    )
    @pytest.mark.parametrize("regular", [True, False])
    def test_matches_interpn_stack(self, mesh, method, regular):
        import interpn_tpu

        x, vals, obs = self._case()
        f = parallel.prepared_stack_evaluator(
            mesh,
            (np.zeros(2), np.ones(2)) if regular else (x, x),
            vals,
            dims=(12, 12) if regular else None,
            method=method,
            regular=regular,
        )
        obs_sh = parallel.shard_obs(obs, mesh)
        out = f(obs_sh)
        assert out.shape == (3, obs[0].shape[0])
        ref = interpn_tpu.interpn_stack(
            [np.asarray(o) for o in obs], [x, x], vals, method=method
        )
        np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-12, atol=1e-12)

    def test_sharding_and_no_collectives(self, mesh):
        import re

        x, vals, obs = self._case()
        f = parallel.prepared_stack_evaluator(
            mesh, (x, x), vals, method="cubic_spline", regular=False
        )
        obs_sh = parallel.shard_obs(obs, mesh)
        out = f(obs_sh)
        assert out.sharding.spec == jax.sharding.PartitionSpec(None, "obs")
        assert len(out.sharding.device_set) == len(mesh.devices.ravel())
        hlo = jax.jit(f).lower(obs_sh).compile().as_text()
        assert not re.findall(
            r"all-reduce|all-gather|collective-permute|reduce-scatter|all-to-all",
            hlo,
        )

    def test_errors(self, mesh):
        x, vals, obs = self._case()
        with pytest.raises(TypeError, match="requires dims="):
            parallel.prepared_stack_evaluator(
                mesh, (np.zeros(2), np.ones(2)), vals, method="linear"
            )
        with pytest.raises(AssertionError, match="Dimension mismatch"):
            parallel.prepared_stack_evaluator(
                mesh, (x, x), vals.ravel(), regular=False
            )
        with pytest.raises(AssertionError, match="at least 6 entries"):
            parallel.prepared_stack_evaluator(
                mesh, (x[:5], x[:5]), vals[:, : 5 * 5], method="quintic",
                regular=False,
            )


def test_sharded_evaluator_pchip_generic(mesh):
    """pchip has a generic table-as-tracer sharded form (no host prep):
    matches the single-chip op and compiles collective-free."""
    import jax.numpy as jnp

    from interpn_tpu import ops

    x = np.arange(10.0)
    xg, yg = np.meshgrid(x, x, indexing="ij")
    vals = (np.sin(xg) + 0.2 * yg**2).ravel()
    rng = np.random.default_rng(31)
    obs = tuple(rng.uniform(0.0, 9.0, 2048) for _ in range(2))

    f = parallel.sharded_evaluator(mesh, method="pchip", regular=True)
    obs_sh = parallel.shard_obs(obs, mesh)
    garrs = (np.zeros(2), np.ones(2))
    out = f(garrs, vals, obs_sh, dims=(10, 10))
    assert out.sharding.spec == jax.sharding.PartitionSpec("obs")
    hlo = f.lower(garrs, vals, obs_sh, dims=(10, 10)).compile().as_text()
    assert not any(op in hlo for op in COLLECTIVES)

    single = ops.pchip_regular(
        (10, 10), jnp.zeros(2), jnp.ones(2), jnp.asarray(vals),
        tuple(jnp.asarray(o) for o in obs),
    )
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(single), rtol=1e-13, atol=1e-13
    )

    g = parallel.sharded_evaluator(mesh, method="pchip", regular=False)
    out_r = g((x, x), vals, obs_sh)
    np.testing.assert_allclose(
        np.asarray(out_r), np.asarray(single), rtol=1e-12, atol=1e-12
    )
