"""Multi-chip evaluation: shard the observation axis over a device mesh.

The reference is single-threaded CPU (SURVEY.md §2.3); the scaling axis here
is the number of query points. Design:

* 1D `Mesh` over all devices with axis name "obs".
* Observation arrays are sharded `P("obs")`; grid definition arrays
  (starts/steps/vals or grids/vals) are replicated.
* Outputs inherit the observation sharding, so the hot path contains ZERO
  collectives — each chip evaluates its slice of queries against its local
  replica of the grid. Only the initial grid broadcast touches the
  interconnect.

`sharded_evaluator` builds a jit-compiled function with those shardings baked
in; it works on GPU meshes and on virtual CPU meshes alike.

Note: the f32 factorized implementation chunks very large query batches with
an internal lax.map whose reshape can force resharding; when driving >10^7
points per chip through the sharded evaluator, prefer sharding first so the
per-device batch stays under the chunk size (the 1e8 sweep in
benches/bench_1e8.py follows this pattern).
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import ops

OBS_AXIS = "obs"


def make_mesh(devices=None, axis_name: str = OBS_AXIS) -> Mesh:
    """A 1D mesh over `devices` (default: all visible devices)."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def obs_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(OBS_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_obs(obs, mesh: Mesh):
    """Place observation arrays on the mesh, split along the obs axis.

    Lengths must be divisible by the mesh size (pad at the call site if not;
    `pad_to_multiple` below helps)."""
    sh = obs_sharding(mesh)
    return tuple(jax.device_put(x, sh) for x in obs)


def pad_to_multiple(x, multiple: int):
    """Pad a 1D array at the end (edge values) to a multiple of `multiple`.

    Edge padding keeps the padded queries inside the grid's numeric range so
    they evaluate harmlessly; callers slice the output back to the original
    length."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    return np.pad(np.asarray(x), (0, rem), mode="edge"), n


_METHODS = {
    ("linear", True): lambda dims, g, v, obs, lin: ops.linear_regular(
        dims, g[0], g[1], v, obs
    ),
    ("nearest", True): lambda dims, g, v, obs, lin: ops.nearest_regular(
        dims, g[0], g[1], v, obs
    ),
    ("cubic", True): lambda dims, g, v, obs, lin: ops.cubic_regular(
        dims, g[0], g[1], v, obs, lin
    ),
    ("linear", False): lambda dims, g, v, obs, lin: ops.linear_rectilinear(g, v, obs),
    ("nearest", False): lambda dims, g, v, obs, lin: ops.nearest_rectilinear(g, v, obs),
    ("cubic", False): lambda dims, g, v, obs, lin: ops.cubic_rectilinear(
        g, v, obs, lin
    ),
    # pchip is the one extension that needs no host prep (its slope build is
    # a pure device function of the table), so it also has a generic
    # table-as-tracer form; the global splines exist only on
    # prepared_evaluator (concrete-table collocation solve).
    ("pchip", True): lambda dims, g, v, obs, lin: ops.pchip_regular(
        dims, g[0], g[1], v, obs
    ),
    ("pchip", False): lambda dims, g, v, obs, lin: ops.pchip_rectilinear(
        g, v, obs
    ),
}


def sharded_evaluator(
    mesh: Mesh,
    *,
    method: str = "linear",
    regular: bool = True,
    linearize_extrapolation: bool = True,
):
    """Build a jit-compiled sharded evaluator.

    Returns ``f(grid_arrays, vals, obs) -> out`` where:
      * regular grids: ``grid_arrays = (starts, steps)`` plus static `dims`
        passed as ``f(..., dims=dims)``;
      * rectilinear grids: ``grid_arrays = tuple(grids)``.
    `obs` is a tuple of observation arrays sharded along the obs axis; the
    output keeps that sharding. Grid arrays are replicated by constraint.
    """
    kernel = _METHODS[(method, regular)]

    @partial(jax.jit, static_argnames=("dims",))
    def f(grid_arrays, vals, obs, dims=None):
        # shard_map, not GSPMD auto-partitioning: each device evaluates its
        # local query shard against the replicated grid, so zero
        # collectives is guaranteed by construction, whatever the engine
        # (GSPMD may all-gather the queries around an op it cannot split).
        def local(grid_arrays, vals, obs):
            return kernel(dims, grid_arrays, vals, obs, linearize_extrapolation)

        sm = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(
                tuple(P() for _ in grid_arrays),
                P(),
                tuple(P(OBS_AXIS) for _ in obs),
            ),
            out_specs=P(OBS_AXIS),
        )
        return sm(tuple(grid_arrays), vals, tuple(obs))

    return f


def prepared_evaluator(
    mesh: Mesh,
    grid_arrays,
    vals,
    *,
    dims=None,
    method: str = "linear",
    regular: bool = True,
    linearize_extrapolation: bool = True,
):
    """Sharded evaluator specialized to one CONCRETE grid + value table.

    For ``regular=True``, ``grid_arrays`` is ``(starts, steps)`` and
    ``dims=`` (the grid shape) is required; for ``regular=False`` it is the
    per-axis grid coordinate arrays and ``dims`` is inferred.

    Closes over `grid_arrays`/`vals` at build time and returns
    ``f(obs) -> out`` (obs sharded along the obs axis, output inherits the
    sharding). The extension methods (``pchip``, ``cubic_spline``,
    ``quintic``) exist only here: the splines' collocation solve runs once
    on the host at build time.
    """
    import jax.numpy as jnp

    if method in ("pchip", "cubic_spline", "quintic"):
        return _prepared_extension(
            mesh, grid_arrays, vals, dims=dims, method=method, regular=regular
        )

    if regular:
        if dims is None:
            raise TypeError(
                "prepared_evaluator(regular=True) requires dims=: pass the "
                "grid shape, with grid_arrays=(starts, steps)"
            )
        dims = tuple(int(d) for d in dims)
        garrs = (jnp.asarray(grid_arrays[0]), jnp.asarray(grid_arrays[1]))
    else:
        garrs = tuple(jnp.asarray(g) for g in grid_arrays)
        dims = tuple(int(g.shape[0]) for g in garrs)
    vals = jnp.asarray(vals)
    generic = sharded_evaluator(
        mesh,
        method=method,
        regular=regular,
        linearize_extrapolation=linearize_extrapolation,
    )
    return lambda obs: generic(garrs, vals, obs, dims=dims)


def _prepared_extension(mesh, grid_arrays, vals, *, dims, method, regular):
    """Sharded evaluator for the extension methods (pchip / global splines).

    These have no `sharded_evaluator` form: the splines require a CONCRETE
    value table (the not-a-knot collocation solve runs on the host,
    `ops/bspline.py`), so closing over build-time prep is the only shape
    that works under `shard_map`. pchip needs no host prep but shares the
    closure pattern. Collective-free by the same construction as the
    reference families: coefficient state rides in replicated (`P()`),
    each device evaluates its local query shard, outputs stay sharded.
    """
    import jax.numpy as jnp

    from ..ops import bspline as _bspline
    from ..ops import pchip as _pchip

    if regular:
        if dims is None:
            raise TypeError(
                "prepared_evaluator(regular=True) requires dims=: pass the "
                "grid shape, with grid_arrays=(starts, steps)"
            )
        dims = tuple(int(d) for d in dims)
        starts = np.asarray(grid_arrays[0])
        steps = np.asarray(grid_arrays[1])
        host_grids = [
            starts[i] + steps[i] * np.arange(dims[i]) for i in range(len(dims))
        ]
    else:
        host_grids = [np.asarray(g) for g in grid_arrays]
        dims = tuple(len(g) for g in host_grids)
    vals = np.asarray(vals)  # concrete by contract (host prep reads it)
    if vals.size != int(np.prod(dims)):
        # the spline branch would fail inside prep_bspline's reshape and
        # the pchip branch only deep inside shard_map — raise the
        # reference-style message up front instead
        raise AssertionError("Dimension mismatch")
    dtype = vals.dtype

    floor = {"pchip": 4, "cubic_spline": 4, "quintic": 6}[method]
    if any(d < floor for d in dims):
        raise AssertionError(f"All grids must have at least {floor} entries")

    if method == "pchip":
        state = (
            tuple(jnp.asarray(g.astype(dtype, copy=False)) for g in host_grids),
            jnp.asarray(vals.ravel()),
        )
        if regular:
            starts_j = jnp.asarray(starts.astype(dtype, copy=False))
            steps_j = jnp.asarray(steps.astype(dtype, copy=False))

            def local(grids, v, obs):
                return _pchip.pchip_regular(dims, starts_j, steps_j, v, obs)
        else:

            def local(grids, v, obs):
                return _pchip.pchip_rectilinear(grids, v, obs)
    else:
        k = 3 if method == "cubic_spline" else 5
        knots, coeffs = _bspline.prep_bspline_cached(
            host_grids, vals.astype(np.float64, copy=False).ravel(), k
        )
        state = (
            tuple(jnp.asarray(t.astype(dtype, copy=False)) for t in knots),
            jnp.asarray(coeffs.astype(dtype, copy=False)),
        )

        def local(knots, coeffs, obs):
            return _bspline.bspline_eval(knots, coeffs, obs, k)

    @jax.jit
    def f(arrs, coeff, obs):
        sm = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(
                tuple(P() for _ in arrs),
                P(),
                tuple(P(OBS_AXIS) for _ in obs),
            ),
            out_specs=P(OBS_AXIS),
        )
        return sm(arrs, coeff, tuple(obs))

    return lambda obs: f(state[0], state[1], obs)


def prepared_stack_evaluator(
    mesh,
    grid_arrays,
    vals,
    *,
    dims=None,
    method: str = "linear",
    regular: bool = True,
    linearize_extrapolation: bool = True,
):
    """Sharded STACKED-table evaluation: `interpn_stack`'s device core on a
    mesh.

    nch value tables sharing one grid evaluate against each device's local
    query shard, with channel tables replicated and the obs axis sharded.
    Every method vmaps the single-table evaluation over the channel axis
    (`ops/stack.py`, `ops/bspline.py`).
    Returns ``f(obs) -> out`` with ``out`` shaped (nch, n), obs axis
    sharded. Collective-free by the same construction as the scalar
    evaluators. Typical workloads: vector fields (u, v, w at once) and
    multi-band lookup tables served data-parallel over a pod.

    `vals` carries the channel axis first — (nch, prod(dims)) or
    (nch, *dims) — and must be concrete at build time (the spline methods
    run their host collocation prep here; the reference methods probe
    finiteness for the forced factorized engine). Extension methods follow
    `prepared_evaluator`'s closure pattern.
    """
    import jax.numpy as jnp

    if regular:
        if dims is None:
            raise TypeError(
                "prepared_stack_evaluator(regular=True) requires dims=: pass "
                "the grid shape, with grid_arrays=(starts, steps)"
            )
        dims = tuple(int(d) for d in dims)
        starts = np.asarray(grid_arrays[0])
        steps = np.asarray(grid_arrays[1])
        host_grids = [
            starts[i] + steps[i] * np.arange(dims[i]) for i in range(len(dims))
        ]
    else:
        host_grids = [np.asarray(g) for g in grid_arrays]
        dims = tuple(len(g) for g in host_grids)
    vals = np.asarray(vals)
    if vals.ndim < 2:
        raise AssertionError("Dimension mismatch")
    nch = vals.shape[0]
    vals2 = vals.reshape(nch, -1)
    dtype = vals2.dtype

    if method in ("pchip", "cubic_spline", "quintic"):
        floor = {"pchip": 4, "cubic_spline": 4, "quintic": 6}[method]
        if any(d < floor for d in dims):
            raise AssertionError(
                f"All grids must have at least {floor} entries"
            )

    if method == "pchip":
        from ..ops import pchip as _pchip

        arrs = tuple(
            jnp.asarray(g.astype(dtype, copy=False)) for g in host_grids
        )
        coeff = jnp.asarray(vals2)
        if regular:
            starts_j = jnp.asarray(starts.astype(dtype, copy=False))
            steps_j = jnp.asarray(steps.astype(dtype, copy=False))

            def local(arrs, v, obs):
                return jax.vmap(
                    lambda t: _pchip.pchip_regular(
                        dims, starts_j, steps_j, t, obs
                    )
                )(v)
        else:

            def local(arrs, v, obs):
                return jax.vmap(
                    lambda t: _pchip.pchip_rectilinear(arrs, t, obs)
                )(v)
    elif method in ("cubic_spline", "quintic"):
        from ..ops import bspline as _bspline

        k = 3 if method == "cubic_spline" else 5
        knots, coeffs = _bspline.prep_bspline_cached(
            host_grids, np.ascontiguousarray(vals2.T, dtype=np.float64), k
        )
        arrs = tuple(
            jnp.asarray(t.astype(dtype, copy=False)) for t in knots
        )
        coeff = jnp.asarray(
            np.ascontiguousarray(coeffs.T).astype(dtype, copy=False)
        )

        def local(arrs, v, obs):
            return _bspline.bspline_eval_stack(arrs, v, obs, k)
    else:
        from .. import ops as _ops

        vf = bool(np.isfinite(vals2).all())
        coeff = jnp.asarray(vals2)
        if regular:
            arrs = (
                jnp.asarray(starts.astype(dtype, copy=False)),
                jnp.asarray(steps.astype(dtype, copy=False)),
            )
            local = {
                "linear": lambda a, v, o: _ops.linear_regular_stack(
                    dims, a[0], a[1], v, o, vals_finite=vf
                ),
                "nearest": lambda a, v, o: _ops.nearest_regular_stack(
                    dims, a[0], a[1], v, o, vals_finite=vf
                ),
                "cubic": lambda a, v, o: _ops.cubic_regular_stack(
                    dims, a[0], a[1], v, o, linearize_extrapolation,
                    vals_finite=vf,
                ),
            }[method]
        else:
            arrs = tuple(jnp.asarray(g) for g in host_grids)
            local = {
                "linear": lambda a, v, o: _ops.linear_rectilinear_stack(
                    a, v, o, vals_finite=vf
                ),
                "nearest": lambda a, v, o: _ops.nearest_rectilinear_stack(
                    a, v, o, vals_finite=vf
                ),
                "cubic": lambda a, v, o: _ops.cubic_rectilinear_stack(
                    a, v, o, linearize_extrapolation, vals_finite=vf
                ),
            }[method]

    @jax.jit
    def f(arrs, coeff, obs):
        sm = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(
                tuple(P() for _ in arrs),
                P(),
                tuple(P(OBS_AXIS) for _ in obs),
            ),
            out_specs=P(None, OBS_AXIS),
        )
        return sm(arrs, coeff, tuple(obs))

    return lambda obs: f(arrs, coeff, obs)
