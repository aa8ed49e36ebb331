"""Functional-transform capabilities beyond the reference: every kernel is a
pure JAX function, so jax.grad / jax.vmap / jax.jit compose with it. These
tests pin that contract (gradients w.r.t. both query positions and grid
values, and batched evaluation over stacked value grids)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import interpn_tpu  # noqa: F401
from interpn_tpu import ops


def _grid2(f):
    x = np.linspace(0.0, 4.0, 5)
    y = np.linspace(0.0, 4.0, 5)
    xg, yg = np.meshgrid(x, y, indexing="ij")
    return jnp.asarray(f(xg, yg).ravel())


def test_grad_wrt_query_linear():
    """d/dx of the multilinear interpolant of 3x - 2y is (3, -2) everywhere
    off the cell boundaries (including extrapolation regions)."""
    vals = _grid2(lambda x, y: 3.0 * x - 2.0 * y)
    starts = jnp.zeros(2)
    steps = jnp.ones(2)

    def f(px, py):
        return ops.linear_regular((5, 5), starts, steps, vals, (px[None], py[None]))[0]

    g = jax.grad(f, argnums=(0, 1))
    for px, py in [(0.3, 1.7), (2.5, 3.1), (-1.2, 5.4)]:
        gx, gy = g(jnp.asarray(px), jnp.asarray(py))
        np.testing.assert_allclose([float(gx), float(gy)], [3.0, -2.0], atol=1e-12)


def test_grad_wrt_query_cubic_quadratic():
    """d/dx of the cubic interpolant of x^2 + y^2 is (2x, 2y) — the quadratic
    reproduction property extends to first derivatives."""
    vals = _grid2(lambda x, y: x**2 + y**2)
    starts = jnp.zeros(2)
    steps = jnp.ones(2)

    def f(px, py):
        return ops.cubic_regular(
            (5, 5), starts, steps, vals, (px[None], py[None]), False
        )[0]

    g = jax.grad(f, argnums=(0, 1))
    for px, py in [(0.4, 1.6), (2.3, 3.3), (-0.7, 4.9)]:
        gx, gy = g(jnp.asarray(px), jnp.asarray(py))
        np.testing.assert_allclose(
            [float(gx), float(gy)], [2 * px, 2 * py], atol=1e-9
        )


def test_grad_wrt_vals_is_corner_weights():
    """The interpolant is linear in the grid values; its gradient w.r.t. vals
    is the stencil weight vector, which sums to 1 for interior points."""
    starts = jnp.zeros(2)
    steps = jnp.ones(2)
    obs = (jnp.asarray([1.3]), jnp.asarray([2.6]))

    def f(vals):
        return ops.linear_regular((5, 5), starts, steps, vals, obs)[0]

    w = jax.grad(f)(jnp.zeros(25))
    assert float(jnp.sum(w)) == pytest.approx(1.0, abs=1e-12)
    assert int(jnp.sum(w != 0)) == 4  # 2^2 stencil


def test_vmap_over_value_grids():
    """Batched evaluation over stacked value grids (multi-channel fields) —
    one vmap, no loops."""
    rng = np.random.default_rng(0)
    channels = jnp.asarray(rng.standard_normal((7, 125)))  # 7 channels on 5^3
    starts = jnp.zeros(3)
    steps = jnp.ones(3)
    obs = tuple(jnp.asarray(rng.uniform(-1, 5, 50)) for _ in range(3))

    batched = jax.vmap(
        lambda v: ops.cubic_regular((5, 5, 5), starts, steps, v, obs, True)
    )
    out = batched(channels)
    assert out.shape == (7, 50)
    single = ops.cubic_regular((5, 5, 5), starts, steps, channels[3], obs, True)
    np.testing.assert_allclose(np.asarray(out[3]), np.asarray(single), atol=1e-12)


def test_jit_grad_composition():
    vals = _grid2(lambda x, y: jnp.sin(x) * jnp.cos(y))
    starts = jnp.zeros(2)
    steps = jnp.ones(2)

    @jax.jit
    def value_and_grad(px, py):
        def f(px, py):
            return ops.cubic_regular(
                (5, 5), starts, steps, vals, (px[None], py[None]), True
            )[0]

        return jax.value_and_grad(f, argnums=(0, 1))(px, py)

    v, (gx, gy) = value_and_grad(jnp.asarray(1.5), jnp.asarray(2.5))
    assert np.isfinite(float(v)) and np.isfinite(float(gx)) and np.isfinite(float(gy))


def test_model_gradient_api():
    """gradient_jax returns per-dimension partial derivatives."""
    import interpn_tpu as it

    x = np.linspace(0.0, 4.0, 5)
    xg, yg = np.meshgrid(x, x, indexing="ij")
    m = it.MulticubicRegular.new(
        [5, 5],
        np.zeros(2),
        np.ones(2),
        (xg**2 + 3.0 * yg).ravel(),
        linearize_extrapolation=False,
    )
    obs = [np.array([1.3, 2.6, 4.9]), np.array([0.4, 3.3, -0.8])]
    gx, gy = m.gradient_jax(obs)
    np.testing.assert_allclose(np.asarray(gx), 2 * obs[0], atol=1e-9)
    np.testing.assert_allclose(np.asarray(gy), [3.0, 3.0, 3.0], atol=1e-9)


def test_donated_core_reuses_query_buffer():
    """The one-shot shims donate freshly-created obs buffers; XLA reuses one
    of them for the output (the reference's zero-extra-allocation `out=`
    contract, SURVEY.md §7 'no-alloc out= semantics')."""
    from interpn_tpu import raw

    vals = jnp.asarray(np.arange(16.0))
    obs_j = tuple(jnp.asarray(np.full(64, 1.5)) for _ in range(2))
    res, _bad = raw._linear_regular_don(
        (4, 4), jnp.zeros(2), jnp.ones(2), vals, obs_j, True
    )
    res.block_until_ready()
    # the donation consumed at least one query buffer
    assert any(o.is_deleted() for o in obs_j)
    # and the plain core (used for caller-owned device arrays) does not
    obs_j2 = tuple(jnp.asarray(np.full(64, 1.5)) for _ in range(2))
    raw._linear_regular(
        (4, 4), jnp.zeros(2), jnp.ones(2), vals, obs_j2, True
    )[0].block_until_ready()
    assert not any(o.is_deleted() for o in obs_j2)


def test_no_allocation_growth_across_repeated_eval():
    """Repeated eval(obs, out) must not leak device allocations: the live
    device-array count is stable across iterations (the persistent model
    caches its grid constants once; per-call buffers are all released)."""
    import interpn_tpu as it

    x = np.linspace(0.0, 4.0, 5)
    xg, yg = np.meshgrid(x, x, indexing="ij")
    m = it.MultilinearRegular.new([5, 5], np.zeros(2), np.ones(2), (xg + yg).ravel())
    obs = [np.random.default_rng(0).uniform(0, 4, 512) for _ in range(2)]
    out = np.zeros(512)
    m.eval(obs, out)  # warm: builds device cache + compiles
    raw_obs = [np.random.default_rng(1).uniform(0, 4, 512) for _ in range(2)]
    it.raw.interpn_linear_regular_f64(
        [5, 5], np.zeros(2), np.ones(2), (xg + yg).ravel(), raw_obs, out
    )
    import gc

    gc.collect()
    base = len(jax.live_arrays())
    for _ in range(5):
        m.eval(obs, out)
        it.raw.interpn_linear_regular_f64(
            [5, 5], np.zeros(2), np.ones(2), (xg + yg).ravel(), raw_obs, out
        )
    gc.collect()
    assert len(jax.live_arrays()) == base


def test_grad_and_vmap_route_to_gather_tree(monkeypatch):
    """jax.grad, jax.vmap and plain jit traces all take the gather tree in
    auto mode, and the gradient equals the one taken through the gather
    tree directly."""
    import interpn_tpu.ops.dispatch as dispatch
    from interpn_tpu.ops import cubic as gc

    dims = (20, 20, 20)
    starts = jnp.zeros(3, jnp.float32)
    steps = jnp.full(3, 0.5, jnp.float32)
    vals = jnp.asarray(np.random.default_rng(0).standard_normal(8000), jnp.float32)
    seen = []

    orig = dispatch._impl

    def spy(*a, **k):
        seen.append(orig(*a, **k))
        return seen[-1]

    monkeypatch.setattr(dispatch, "_impl", spy)

    def f(x, fn=ops.cubic_regular):
        obs = (x * jnp.linspace(0.0, 9.0, 2048), jnp.ones(2048), jnp.ones(2048))
        return jnp.sum(fn(dims, starts, steps, vals, obs, True))

    g = jax.grad(f)(jnp.float32(0.7))
    assert seen and all(impl == "gather" for impl in seen), seen
    np.testing.assert_allclose(
        float(g), float(jax.grad(lambda x: f(x, gc.cubic_regular))(jnp.float32(0.7))),
        rtol=1e-6,
    )
    seen.clear()
    jax.make_jaxpr(jax.vmap(lambda v: ops.cubic_regular(
        dims, starts, steps, v, (jnp.ones(2048),) * 3, True
    )))(jnp.zeros((2, 8000), jnp.float32))
    assert seen and all(impl == "gather" for impl in seen), seen
    seen.clear()
    jax.make_jaxpr(f)(jnp.float32(1.0))
    assert seen == ["gather"], seen


def test_leaf_event_total_sums_siblings_not_parents(tmp_path):
    """device_kernel_time's trace accounting (ADVICE r2 #3): chunked
    same-named launches AND differently-named sibling kernels all count;
    the nesting jit parent event does not; coincident duplicates survive."""
    import gzip
    import json

    from interpn_tpu.utils.profiling import _leaf_event_total

    d = tmp_path / "plugins" / "profile" / "run"
    d.mkdir(parents=True)
    events = [
        {"ph": "X", "name": "jit__kernel_wrap", "pid": 1, "tid": 1, "ts": 0, "dur": 100},
        {"ph": "X", "name": "_kernel_main", "pid": 1, "tid": 1, "ts": 5, "dur": 30},
        {"ph": "X", "name": "_kernel_main", "pid": 1, "tid": 1, "ts": 40, "dur": 30},
        {"ph": "X", "name": "_kernel_tail", "pid": 1, "tid": 1, "ts": 75, "dur": 10},
        # a different lane must not be treated as a parent of lane 1 events
        {"ph": "X", "name": "_kernel_other_lane", "pid": 1, "tid": 2, "ts": 0, "dur": 7},
        # non-matching events are ignored entirely
        {"ph": "X", "name": "copy_done", "pid": 1, "tid": 1, "ts": 6, "dur": 2},
    ]
    with gzip.open(d / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    assert _leaf_event_total(str(tmp_path), "_kernel") == 30 + 30 + 10 + 7

    # coincident duplicates: neither vanishes
    with gzip.open(d / "host.trace.json.gz", "wt") as f:
        json.dump(
            {"traceEvents": [
                {"ph": "X", "name": "_kernel_a", "pid": 1, "tid": 1, "ts": 0, "dur": 5},
                {"ph": "X", "name": "_kernel_a", "pid": 1, "tid": 1, "ts": 0, "dur": 5},
            ]},
            f,
        )
    assert _leaf_event_total(str(tmp_path), "_kernel") == 10
