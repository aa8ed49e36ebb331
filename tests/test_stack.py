"""Stacked-table (multi-channel) evaluation: the vmapped stack path vs
per-channel evaluation through the gather tree, the forced-engine rule, and
the public `interpn_stack` helper."""

import numpy as np
import pytest

import interpn_tpu
import jax
import jax.numpy as jnp

from interpn_tpu import ops
from interpn_tpu.ops import cubic as gc
from interpn_tpu.ops import linear as gl
from interpn_tpu.ops import nearest as gn


def _case(dims, nch, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    starts = jnp.asarray(rng.uniform(-1, 1, len(dims)), dtype)
    steps = jnp.asarray(rng.uniform(0.3, 1.0, len(dims)), dtype)
    vals = jnp.asarray(
        rng.standard_normal((nch, int(np.prod(dims)))), dtype
    )
    n = 700
    obs = tuple(
        jnp.asarray(
            rng.uniform(
                float(starts[k]) - 2 * float(steps[k]),
                float(starts[k]) + float(steps[k]) * (dims[k] + 1),
                n,
            ),
            dtype,
        )
        for k in range(len(dims))
    )
    return starts, steps, vals, obs


# ---------------------------------------------------------------------
# Stack output == per-channel gather-tree output
# ---------------------------------------------------------------------

_STACK = {
    "linear": (ops.linear_regular_stack, lambda d, s, p, v, o: gl.linear_regular(d, s, p, v, o)),
    "cubic": (ops.cubic_regular_stack, lambda d, s, p, v, o: gc.cubic_regular(d, s, p, v, o, True)),
    "nearest": (ops.nearest_regular_stack, lambda d, s, p, v, o: gn.nearest_regular(d, s, p, v, o)),
}
_RECT_STACK = {
    "linear": (ops.linear_rectilinear_stack, lambda g, v, o: gl.linear_rectilinear(g, v, o)),
    "cubic": (ops.cubic_rectilinear_stack, lambda g, v, o: gc.cubic_rectilinear(g, v, o, True)),
    "nearest": (ops.nearest_rectilinear_stack, lambda g, v, o: gn.nearest_rectilinear(g, v, o)),
}


@pytest.mark.parametrize("dims", [(8, 12), (10, 10, 10), (6, 5, 4, 7)])
@pytest.mark.parametrize("method", ["linear", "cubic", "nearest"])
def test_stack_matches_per_channel(dims, method):
    starts, steps, vals, obs = _case(dims, nch=3, seed=1)
    stack_fn, single = _STACK[method]
    got = stack_fn(dims, starts, steps, vals, obs)
    assert got.shape == (3, obs[0].shape[0])
    for c in range(3):
        ref = single(dims, starts, steps, vals[c], obs)
        # vmap batches the same program: f32 association order may differ
        # only through fusion choices, so compare at f32 rounding
        np.testing.assert_allclose(
            np.asarray(got[c]), np.asarray(ref), rtol=2e-6, atol=2e-6,
            err_msg=f"channel {c} ({method}, {dims})",
        )


def test_stack_single_channel_identity():
    """nch=1 agrees with the single-table gather tree."""
    dims = (10, 10, 10)
    starts, steps, vals, obs = _case(dims, nch=1, seed=2)
    got = ops.cubic_regular_stack(dims, starts, steps, vals, obs, True)
    ref = gc.cubic_regular(dims, starts, steps, vals[0], obs, True)
    np.testing.assert_allclose(
        np.asarray(got[0]), np.asarray(ref), rtol=2e-6, atol=2e-6
    )


def test_stack_nearest_bit_exact():
    """Nearest selection reproduces grid values exactly per channel."""
    dims = (9, 11)
    starts, steps, vals, obs = _case(dims, nch=4, seed=3)
    got = ops.nearest_regular_stack(dims, starts, steps, vals, obs)
    for c in range(4):
        ref = np.asarray(gn.nearest_regular(dims, starts, steps, vals[c], obs))
        np.testing.assert_array_equal(np.asarray(got[c]), ref)


def _rect_stack_case(dims, nch, seed, n=500, pad=0.5):
    rng = np.random.default_rng(seed)
    grids = tuple(
        jnp.asarray(np.cumsum(rng.uniform(0.2, 1.0, d)), jnp.float32)
        for d in dims
    )
    vals = jnp.asarray(rng.standard_normal((nch, int(np.prod(dims)))), jnp.float32)
    obs = tuple(
        jnp.asarray(
            rng.uniform(float(g[0]) - pad, float(g[-1]) + pad, n), jnp.float32
        )
        for g in grids
    )
    return grids, vals, obs


@pytest.mark.parametrize("method", ["linear", "cubic", "nearest"])
def test_stack_rectilinear_f32_matches_per_channel(method):
    grids, vals, obs = _rect_stack_case((9, 8, 7), nch=3, seed=5)
    stack_fn, single = _RECT_STACK[method]
    got = stack_fn(grids, vals, obs)
    for c in range(3):
        np.testing.assert_allclose(
            np.asarray(got[c]), np.asarray(single(grids, vals[c], obs)),
            rtol=2e-6, atol=2e-6, err_msg=f"{method} channel {c}",
        )


# ---------------------------------------------------------------------
# Dispatch fallbacks (CPU: vmap / per-channel loop) vs single-channel
# ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("method", ["linear", "cubic", "nearest"])
def test_stack_dispatch_regular(method, dtype):
    dims = (8, 9, 7)
    starts, steps, vals, obs = _case(dims, nch=3, seed=7, dtype=dtype)
    fn = {
        "linear": ops.linear_regular_stack,
        "cubic": ops.cubic_regular_stack,
        "nearest": ops.nearest_regular_stack,
    }[method]
    got = fn(dims, starts, steps, vals, obs)
    assert got.shape == (3, obs[0].shape[0])
    single = {
        "linear": ops.linear_regular,
        "cubic": ops.cubic_regular,
        "nearest": ops.nearest_regular,
    }[method]
    for c in range(3):
        args = (dims, starts, steps, vals[c], obs)
        ref = single(*args) if method != "cubic" else single(*args, True)
        np.testing.assert_array_equal(np.asarray(got[c]), np.asarray(ref))


@pytest.mark.parametrize("method", ["linear", "cubic", "nearest"])
def test_stack_dispatch_rectilinear(method):
    dims = (8, 9, 7)
    rng = np.random.default_rng(11)
    grids = tuple(
        jnp.asarray(np.cumsum(rng.uniform(0.2, 1.0, d)), jnp.float64)
        for d in dims
    )
    vals = jnp.asarray(rng.standard_normal((2, int(np.prod(dims)))))
    n = 400
    obs = tuple(
        jnp.asarray(rng.uniform(float(g[0]) - 0.5, float(g[-1]) + 0.5, n))
        for g in grids
    )
    fn = {
        "linear": ops.linear_rectilinear_stack,
        "cubic": ops.cubic_rectilinear_stack,
        "nearest": ops.nearest_rectilinear_stack,
    }[method]
    single = {
        "linear": ops.linear_rectilinear,
        "cubic": ops.cubic_rectilinear,
        "nearest": ops.nearest_rectilinear,
    }[method]
    got = fn(grids, vals, obs)
    for c in range(2):
        args = (grids, vals[c], obs)
        ref = single(*args) if method != "cubic" else single(*args, True)
        np.testing.assert_array_equal(np.asarray(got[c]), np.asarray(ref))


def test_stack_dispatch_under_jit_and_grad():
    """The stack ops stay jittable and the vmap fallback differentiates."""
    dims = (6, 7)
    starts, steps, vals, obs = _case(dims, nch=2, seed=13, dtype=np.float64)

    f = jax.jit(
        lambda v: jnp.sum(ops.linear_regular_stack(dims, starts, steps, v, obs))
    )
    assert np.isfinite(float(f(vals)))
    g = jax.grad(lambda v: jnp.sum(
        ops.cubic_regular_stack(dims, starts, steps, v, obs, True)
    ))(vals)
    assert g.shape == vals.shape
    assert bool(jnp.isfinite(g).all())


# ---------------------------------------------------------------------
# Public helper
# ---------------------------------------------------------------------


def test_interpn_stack_matches_interpn():
    rng = np.random.default_rng(17)
    x = np.linspace(0.0, 1.0, 12)
    y = np.linspace(-1.0, 2.0, 9)
    grids = [x, y]
    vals = rng.standard_normal((4, 12, 9))
    obs = [rng.uniform(-0.2, 1.2, (25, 2))[:, 0], rng.uniform(-1.2, 2.2, 25)]
    for method in ("linear", "cubic", "nearest"):
        got = interpn_tpu.interpn_stack(obs, grids, vals, method=method)
        assert got.shape == (4, 25)
        for c in range(4):
            ref = interpn_tpu.interpn(obs, grids, vals[c].ravel(), method=method)
            if method == "nearest":
                # pure selection: identical values whatever the engine
                np.testing.assert_array_equal(got[c], ref)
            else:
                # interpn routes small batches to the native C++ kernels;
                # the stack evaluates on the JAX path — same math, different
                # association order
                np.testing.assert_allclose(got[c], ref, rtol=1e-13, atol=1e-14)


def test_interpn_stack_rectilinear_autodetect():
    rng = np.random.default_rng(19)
    gx = np.cumsum(rng.uniform(0.2, 1.0, 10))
    gy = np.cumsum(rng.uniform(0.2, 1.0, 8))
    vals = rng.standard_normal((3, 10, 8)).astype(np.float32)
    obs = [
        rng.uniform(gx[0], gx[-1], 30).astype(np.float32),
        rng.uniform(gy[0], gy[-1], 30).astype(np.float32),
    ]
    got = interpn_tpu.interpn_stack(
        obs, [gx.astype(np.float32), gy.astype(np.float32)], vals,
        method="linear",
    )
    for c in range(3):
        ref = interpn_tpu.interpn(
            obs, [gx.astype(np.float32), gy.astype(np.float32)],
            vals[c].ravel(), method="linear",
        )
        np.testing.assert_allclose(got[c], ref, rtol=2e-6, atol=2e-6)


def test_interpn_stack_obs_shape_round_trip():
    rng = np.random.default_rng(23)
    x = np.linspace(0.0, 1.0, 6)
    vals = rng.standard_normal((2, 6, 6))
    ox = rng.uniform(0, 1, (5, 4))
    oy = rng.uniform(0, 1, (5, 4))
    got = interpn_tpu.interpn_stack([ox, oy], [x, x], vals)
    assert got.shape == (2, 5, 4)


def test_interpn_stack_errors():
    x = np.linspace(0.0, 1.0, 6)
    vals = np.zeros((2, 36))
    obs = [np.full(4, 0.5), np.full(4, 0.5)]
    with pytest.raises(ValueError, match="violate interpolator bounds"):
        interpn_tpu.interpn_stack(
            [np.full(4, 2.0), np.full(4, 0.5)], [x, x], vals,
            check_bounds=True,
        )
    with pytest.raises(AssertionError, match="Size of value array"):
        interpn_tpu.interpn_stack(obs, [x, x], np.zeros((2, 35)))
    with pytest.raises(AssertionError, match="Dimension mismatch"):
        interpn_tpu.interpn_stack(obs, [x, x], np.zeros(36))
    with pytest.raises(TypeError, match="share one float dtype"):
        interpn_tpu.interpn_stack(
            [o.astype(np.float32) for o in obs], [x, x], vals
        )
    with pytest.raises(AssertionError, match="float32 and float64"):
        interpn_tpu.interpn_stack(obs, [x, x], vals.astype(np.int32))


# ---------------------------------------------------------------------
# jit / jvp through the stack, and the forced factorized engine
# ---------------------------------------------------------------------


def _routing_case(dims, nch, seed, dtype=np.float32, n=1536):
    rng = np.random.default_rng(seed)
    starts = jnp.asarray(rng.uniform(-1, 1, len(dims)), dtype)
    steps = jnp.asarray(rng.uniform(0.3, 1.0, len(dims)), dtype)
    vals = jnp.asarray(rng.standard_normal((nch, int(np.prod(dims)))), dtype)
    obs = tuple(
        jnp.asarray(
            rng.uniform(
                float(starts[k]) - 2 * float(steps[k]),
                float(starts[k]) + float(steps[k]) * (dims[k] + 1),
                n,
            ),
            dtype,
        )
        for k in range(len(dims))
    )
    return starts, steps, vals, obs


@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_stack_under_jit_matches_per_channel(method):
    """The jitted stack equals the per-channel gather tree."""
    dims = (8, 9, 7)
    starts, steps, vals, obs = _routing_case(dims, nch=3, seed=21)
    stack_fn, single = _STACK[method]
    got = np.asarray(
        jax.jit(lambda v: stack_fn(dims, starts, steps, v, obs))(vals)
    )
    for c in range(3):
        ref = single(dims, starts, steps, vals[c], obs)
        # jit fuses the extrapolated cubic tree differently: f32 rounding
        # amplified by up to two cells of extrapolation
        np.testing.assert_allclose(got[c], np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_stack_jvp_matches_per_channel_jvp():
    """Differentiating the jitted stack gives the per-channel gather
    tree's tangents."""
    dims = (8, 9, 7)
    starts, steps, vals, obs = _routing_case(dims, nch=2, seed=23)
    f = jax.jit(lambda v: ops.linear_regular_stack(dims, starts, steps, v, obs))
    tangent = jnp.ones_like(vals)
    _, dout = jax.jvp(f, (vals,), (tangent,))

    def g(v):
        return jnp.stack(
            [gl.linear_regular(dims, starts, steps, v[c], obs) for c in range(2)]
        )

    _, dref = jax.jvp(g, (vals,), (tangent,))
    np.testing.assert_allclose(np.asarray(dout), np.asarray(dref), rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("finite", [True, False])
def test_stack_forced_factorized(monkeypatch, finite):
    """INTERPN_TPU_IMPL=factorized reaches the factorized engine through the
    stack's vmap when the table is finite, and keeps the gather tree's
    result when one channel holds an inf sentinel."""
    from interpn_tpu.ops import factorized as fz

    dims = (6, 5)
    starts, steps, vals, obs = _routing_case(dims, nch=3, seed=24, dtype=np.float64)
    if not finite:
        vals = vals.at[1, 0].set(jnp.inf)
    ref = np.stack([
        np.asarray(gl.linear_regular(dims, starts, steps, vals[c], obs))
        for c in range(3)
    ])
    calls = []
    real = fz.linear_regular_factorized
    monkeypatch.setattr(
        fz, "linear_regular_factorized",
        lambda *a, **k: calls.append(1) or real(*a, **k),
    )
    monkeypatch.setenv("INTERPN_TPU_IMPL", "factorized")
    got = np.asarray(ops.linear_regular_stack(dims, starts, steps, vals, obs))
    assert bool(calls) == finite
    if finite:
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("method", ["nearest", "cubic"])
def test_stack_rect_and_nearest_jvp(method):
    """JVP through the jitted rectilinear stack equals the per-channel
    gather tree's tangents."""
    grids, vals, obs = _rect_stack_case((8, 7, 6), nch=2, seed=26, n=1536, pad=0.0)
    stack_fn, single = _RECT_STACK[method]
    tangent = jnp.ones_like(vals)
    _, dout = jax.jvp(jax.jit(lambda v: stack_fn(grids, v, obs)), (vals,), (tangent,))
    assert dout.shape == (2, 1536)
    _, dref = jax.jvp(
        lambda v: jnp.stack([single(grids, v[c], obs) for c in range(2)]),
        (vals,), (tangent,),
    )
    np.testing.assert_allclose(np.asarray(dout), np.asarray(dref), rtol=2e-6, atol=2e-6)
