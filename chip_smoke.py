"""Smoke run of interpn-tpu on a GPU: the main path once, through the public
entry points, at the sizes its users run, each result checked against the
repository's plain references.

    python chip_smoke.py              # one GPU: every single-device phase
    python chip_smoke.py --multichip  # four GPUs: the sharded path only

It runs as one process that owns the card(s). It exits non-zero, without a
result line, when JAX's first device is not a GPU or when any phase fails.
Earlier lines give the card's name and power limit (nvidia-smi), the JAX
version, the compilation-cache directory, each comparison's maximum error
beside its tolerance, compile seconds per phase and informational timings.
The last line is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

References: tests/oracle.py (per-point numpy transliteration of the
reference semantics) for linear / cubic / nearest; scipy for pchip (RGI),
the global splines (NdBSpline on coefficients scipy solves itself) and the
scipy adapter. The oracles are slow, so each comparison uses a fixed-seed
subsample of the batch.

Tolerances, each relative to a stated scale:
* f64: 1e-12 x max|table| — the bar the reference's own parity tests use.
* f32: 1e-5 x the larger of max|table| and the sample's max|reference|:
  f32 rounding through the cubic tree, amplified by up to two cells of
  extrapolation.
* nearest: exact.
* global splines: 1e-12 x max|coefficients| — the two coefficient solves
  (ours and scipy's) round differently, and not-a-knot coefficients can
  exceed the data scale.
The factorized engine runs its einsums at precision=HIGHEST, so it is held
to the same bars; TF32 would miss the f32 one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback
from dataclasses import dataclass

import numpy as np

TOL_F64 = 1e-12
TOL_F32 = 1e-5
OOB_SHARE = 0.1  # share of each batch placed out of bounds (extrapolation)


@dataclass(frozen=True)
class Sizes:
    core_tables: tuple = (20, 100)  # points per axis, 3D
    core_n: int = 1 << 20
    big_table: int = 256  # 256^3 f64 = 134 MB, past the H100's 50 MB L2
    big_n: int = 1 << 22
    highd_points: int = 8  # 6D cubic on 8^6 cells: 4,096 vertices per query
    highd_n: int = 1 << 16
    ext_table: int = 20
    ext_n: int = 1 << 18
    stack_channels: int = 8
    stack_n: int = 1 << 20
    one_dim_n: int = 1 << 20
    sample: int = 16384
    # the 6D cubic oracle costs ~4 ms per point, so it samples fewer
    highd_sample: int = 2048
    shard_n: int = 1 << 22
    timing_reps: int = 5


FULL = Sizes()
TINY = Sizes(
    core_tables=(6,), core_n=4096, big_table=10, big_n=4096, highd_points=4,
    highd_n=512, ext_table=7, ext_n=2048, stack_channels=3, stack_n=2048,
    one_dim_n=4096, sample=48, highd_sample=8, shard_n=4096, timing_reps=2,
)


class PhaseFailure(AssertionError):
    pass


@contextlib.contextmanager
def _env(**kv):
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update({k: v for k, v in kv.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _report(phase, label, got, ref, scale, tol, exact=False):
    """Print one comparison; raise PhaseFailure when it misses its bar."""
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if got.shape != ref.shape:
        raise PhaseFailure(f"{phase} {label}: shape {got.shape} != {ref.shape}")
    if not np.isfinite(got).all():
        raise PhaseFailure(f"{phase} {label}: non-finite output")
    err = float(np.max(np.abs(got - ref))) if got.size else 0.0
    bar = 0.0 if exact else tol * scale
    ok = err <= bar
    print(f"phase {phase}: {label} max_err={err:.3e} tol={bar:.3e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise PhaseFailure(f"{phase} {label}: max_err {err:.3e} > {bar:.3e}")


def _tol(dtype):
    return TOL_F64 if dtype == np.float64 else TOL_F32


# ---------------------------------------------------------------------------
# Data, made from a seed
# ---------------------------------------------------------------------------


def _regular_axis(n):
    """n exactly-regular points over [0, 1]-ish: a dyadic step keeps every
    spacing bit-equal in f32 and f64, so interpn detects a regular grid."""
    h = 2.0 ** -int(np.ceil(np.log2(n - 1)))
    return np.arange(n) * h


def _rect_axis(n, rng):
    x = np.cumsum(rng.uniform(0.5, 1.5, n))
    return (x - x[0]) / (x[-1] - x[0])


def _queries(grids, n, rng):
    """Uniform queries inside the grid; OOB_SHARE of them pushed up to two
    cells past one edge of one axis."""
    nd = len(grids)
    obs = [rng.uniform(g[0], g[-1], n) for g in grids]
    out = rng.random(n) < OOB_SHARE
    axis = rng.integers(0, nd, n)
    side = rng.random(n) < 0.5
    for k, g in enumerate(grids):
        sel = out & (axis == k)
        cell = (g[-1] - g[0]) / (len(g) - 1)
        depth = rng.uniform(0.0, 2.0, n) * cell
        obs[k] = np.where(sel & side, g[0] - depth, obs[k])
        obs[k] = np.where(sel & ~side, g[-1] + depth, obs[k])
    return obs


def _table(dims, rng):
    return rng.standard_normal(int(np.prod(dims)))


def _oracle(method, grids, regular, vals, obs, idx):
    from tests import oracle

    v = np.asarray(vals, np.float64)
    gs = [np.asarray(g, np.float64) for g in grids]
    pts = [[float(o[i]) for o in obs] for i in idx]
    dims = [len(g) for g in gs]
    if regular:
        st = np.array([g[0] for g in gs])
        sp = np.array([g[1] - g[0] for g in gs])
        if method == "cubic":
            return np.array([oracle.cubic_regular(dims, st, sp, v, p, True) for p in pts])
        fn = getattr(oracle, f"{method}_regular")
        return np.array([fn(dims, st, sp, v, p) for p in pts])
    if method == "cubic":
        return np.array([oracle.cubic_rectilinear(gs, v, p, True) for p in pts])
    fn = getattr(oracle, f"{method}_rectilinear")
    return np.array([fn(gs, v, p) for p in pts])


def _timed(fn):
    """(result, seconds) of one blocking call."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def _first_and_second(fn):
    """Run fn twice: (result, compile-dominated first seconds, second
    seconds). The difference is reported as compile time."""
    out, t1 = _timed(fn)
    _, t2 = _timed(fn)
    return out, t1, t2


# ---------------------------------------------------------------------------
# Phases. Each returns its compile seconds (first call minus second call).
# ---------------------------------------------------------------------------


def phase_core(sizes, rng):
    """interpn() for linear / cubic / nearest on regular and rectilinear 3D
    grids, in f32 and f64, on the device."""
    import jax
    import interpn_tpu as it

    compile_s = 0.0
    with _env(INTERPN_TPU_NATIVE="0"):
        for n_axis in sizes.core_tables:
            for regular in (True, False):
                grids64 = [
                    _regular_axis(n_axis) if regular else _rect_axis(n_axis, rng)
                    for _ in range(3)
                ]
                vals64 = _table([n_axis] * 3, rng)
                obs64 = _queries(grids64, sizes.core_n, rng)
                idx = rng.choice(sizes.core_n, min(sizes.sample, sizes.core_n), replace=False)
                for dtype in (np.float32, np.float64):
                    grids = [g.astype(dtype) for g in grids64]
                    assert it._check_regular(grids) == regular
                    vals = vals64.astype(dtype)
                    obs = [o.astype(dtype) for o in obs64]
                    dev = [jax.device_put(a) for a in (*grids, vals, *obs)]
                    g_d, v_d, o_d = dev[:3], dev[3], dev[4:]
                    for method in ("linear", "cubic", "nearest"):
                        out, t1, t2 = _first_and_second(
                            lambda: it.interpn(o_d, g_d, v_d, method=method)
                        )
                        compile_s += max(t1 - t2, 0.0)
                        ref = _oracle(method, grids, regular, vals, obs, idx)
                        scale = max(float(np.abs(vals).max()), float(np.abs(ref).max()))
                        kind = "regular" if regular else "rectilinear"
                        _report(
                            "core",
                            f"{method} {kind} {np.dtype(dtype).name} {n_axis}^3 "
                            f"n={sizes.core_n}",
                            np.asarray(out)[idx], ref, scale, _tol(dtype),
                            exact=method == "nearest",
                        )
    return compile_s


def phase_big_table(sizes, rng):
    """One f64 table past the card's 50 MB L2: linear and cubic."""
    import jax
    import interpn_tpu as it

    compile_s = 0.0
    n_axis = sizes.big_table
    grids = [_regular_axis(n_axis) for _ in range(3)]
    vals = _table([n_axis] * 3, rng)
    obs = _queries(grids, sizes.big_n, rng)
    idx = rng.choice(sizes.big_n, min(sizes.sample, sizes.big_n), replace=False)
    g_d = [jax.device_put(g) for g in grids]
    v_d = jax.device_put(vals)
    o_d = [jax.device_put(o) for o in obs]
    print(f"phase big_table: table {vals.nbytes / 1e6:.1f} MB f64", flush=True)
    with _env(INTERPN_TPU_NATIVE="0"):
        for method in ("linear", "cubic"):
            out, t1, t2 = _first_and_second(
                lambda: it.interpn(o_d, g_d, v_d, method=method)
            )
            compile_s += max(t1 - t2, 0.0)
            ref = _oracle(method, grids, True, vals, obs, idx)
            _report("big_table", f"{method} f64 {n_axis}^3 n={sizes.big_n}",
                    np.asarray(out)[idx], ref, float(np.abs(vals).max()), TOL_F64)
    return compile_s


def phase_high_dim(sizes, rng):
    """6D cubic f64: 4^6 = 4,096 vertices per query through ops/_chunk.py."""
    import jax
    import interpn_tpu as it

    grids = [_regular_axis(sizes.highd_points) for _ in range(6)]
    vals = _table([sizes.highd_points] * 6, rng)
    obs = _queries(grids, sizes.highd_n, rng)
    idx = rng.choice(sizes.highd_n, min(sizes.highd_sample, sizes.highd_n), replace=False)
    g_d = [jax.device_put(g) for g in grids]
    v_d = jax.device_put(vals)
    o_d = [jax.device_put(o) for o in obs]
    with _env(INTERPN_TPU_NATIVE="0"):
        out, t1, t2 = _first_and_second(
            lambda: it.interpn(o_d, g_d, v_d, method="cubic")
        )
    print(f"phase high_dim: 6D cubic compile_s={max(t1 - t2, 0.0):.2f} "
          f"run_s={t2:.4f}", flush=True)
    ref = _oracle("cubic", grids, True, vals, obs, idx)
    _report("high_dim", f"cubic f64 {sizes.highd_points}^6 n={sizes.highd_n}",
            np.asarray(out)[idx], ref, float(np.abs(vals).max()), TOL_F64)
    return max(t1 - t2, 0.0)


def _scipy_spline_coeffs(grids, vals, k):
    """Tensor-product not-a-knot coefficients solved by scipy alone."""
    import scipy.interpolate as si

    c = vals
    knots = []
    for ax, x in enumerate(grids):
        spl = si.make_interp_spline(x, c, k=k, axis=ax)
        knots.append(spl.t)
        c = np.moveaxis(spl.c, 0, ax)  # scipy keeps the fitted axis first
    return knots, c


def phase_extensions(sizes, rng):
    """pchip / cubic_spline / quintic through interpn(), interpn_stack with
    several channels, and ops.one_dim linear."""
    import jax
    import jax.numpy as jnp
    import scipy.interpolate as si

    import interpn_tpu as it
    from interpn_tpu.ops import one_dim

    compile_s = 0.0
    n_axis = sizes.ext_table
    grids = [_regular_axis(n_axis) for _ in range(3)]
    vals = _table([n_axis] * 3, rng)
    obs = _queries(grids, sizes.ext_n, rng)
    idx = rng.choice(sizes.ext_n, min(sizes.sample, sizes.ext_n), replace=False)
    pts = np.stack([o[idx] for o in obs], axis=1)
    g_d = [jax.device_put(g) for g in grids]
    v_d = jax.device_put(vals)
    o_d = [jax.device_put(o) for o in obs]
    for method in ("pchip", "cubic_spline", "quintic"):
        out, t1, t2 = _first_and_second(
            lambda: it.interpn(o_d, g_d, v_d, method=method)
        )
        compile_s += max(t1 - t2, 0.0)
        cube = vals.reshape([n_axis] * 3)
        if method == "pchip":
            ref = si.RegularGridInterpolator(
                tuple(grids), cube, method="pchip", bounds_error=False,
                fill_value=None,
            )(pts)
            scale = float(np.abs(vals).max())
        else:
            k = 3 if method == "cubic_spline" else 5
            knots, coeffs = _scipy_spline_coeffs(grids, cube, k)
            ref = si.NdBSpline(tuple(knots), coeffs, k, extrapolate=True)(pts)
            scale = float(np.abs(coeffs).max())
        _report("extensions", f"{method} f64 {n_axis}^3 n={sizes.ext_n}",
                np.asarray(out)[idx], ref, scale, TOL_F64)

    # interpn_stack: channels on one grid vs per-channel interpn (host data)
    nch = sizes.stack_channels
    sgrids = [g.astype(np.float32) for g in grids]
    stack = rng.standard_normal((nch, n_axis, n_axis, n_axis)).astype(np.float32)
    sobs = [o.astype(np.float32) for o in _queries(grids, sizes.stack_n, rng)]
    with _env(INTERPN_TPU_NATIVE="0"):
        got, t1, t2 = _first_and_second(
            lambda: it.interpn_stack(sobs, sgrids, stack, method="linear")
        )
        compile_s += max(t1 - t2, 0.0)
        for c in range(nch):
            ref = it.interpn(sobs, sgrids, stack[c], method="linear")
            _report("extensions",
                    f"interpn_stack linear f32 ch{c}/{nch} n={sizes.stack_n}",
                    got[c], ref, float(np.abs(stack[c]).max()), TOL_F32)

    # ops.one_dim: Linear1D on a regular grid, vs the 1D oracle
    x = _regular_axis(1000)
    y = rng.standard_normal(1000)
    q = _queries([x], sizes.one_dim_n, rng)[0]
    itp = one_dim.Linear1D(
        one_dim.RegularGrid1D(jnp.asarray(x[0]), jnp.asarray(x[1] - x[0]), jnp.asarray(y))
    )
    q_d = jax.device_put(q)
    f = jax.jit(itp._eval)
    out, t1, t2 = _first_and_second(lambda: f(q_d))
    compile_s += max(t1 - t2, 0.0)
    qidx = rng.choice(len(q), min(sizes.sample, len(q)), replace=False)
    ref = _oracle("linear", [x], True, y, [q], qidx)
    _report("extensions", f"one_dim Linear1D f64 n={sizes.one_dim_n}",
            np.asarray(out)[qidx], ref, float(np.abs(y).max()), TOL_F64)
    return compile_s


def phase_compat(sizes, rng):
    """compat.RegularGridInterpolator (f64, fill_value, bounds_error=False)
    against scipy's with the same arguments."""
    import jax
    import scipy.interpolate as si

    from interpn_tpu import compat

    grids = [_rect_axis(sizes.ext_table, rng) for _ in range(3)]
    vals = _table([sizes.ext_table] * 3, rng).reshape([sizes.ext_table] * 3)
    obs = _queries(grids, sizes.core_n, rng)
    xi = np.stack(obs, axis=1)
    xi_d = jax.device_put(xi)
    idx = rng.choice(len(xi), min(sizes.sample, len(xi)), replace=False)
    with _env(INTERPN_TPU_NATIVE="0"):
        ours = compat.RegularGridInterpolator(
            tuple(grids), vals, method="linear", bounds_error=False, fill_value=-7.5
        )
        out, t1, t2 = _first_and_second(lambda: ours(xi_d))
    ref = si.RegularGridInterpolator(
        tuple(grids), vals, method="linear", bounds_error=False, fill_value=-7.5
    )(xi[idx])
    filled = int(np.sum(ref == -7.5))
    _report("compat", f"RegularGridInterpolator linear f64 fill (filled {filled}/"
            f"{len(idx)}) n={len(xi)}", np.asarray(out)[idx], ref,
            float(np.abs(vals).max()), TOL_F64)
    return max(t1 - t2, 0.0)


def phase_gradients(sizes, rng):
    """jax.grad of a JaxInterpolator with respect to its table. The table
    gradient G of sum_i c_i f(x_i) is the c-weighted sum of the queries'
    linear weights, so <G, v> must equal sum_i c_i oracle(v, x_i) for any
    table v."""
    import jax
    import jax.numpy as jnp

    from interpn_tpu.functional import JaxInterpolator
    from tests import oracle

    n_axis = sizes.ext_table
    grids = [_regular_axis(n_axis) for _ in range(3)]
    dims = (n_axis,) * 3
    vals = _table(dims, rng)
    obs = _queries(grids, sizes.core_n, rng)
    idx = rng.choice(sizes.core_n, min(sizes.sample, sizes.core_n), replace=False)
    c = rng.standard_normal(len(idx))
    starts = np.zeros(3)
    steps = np.full(3, grids[0][1] - grids[0][0])
    itp = JaxInterpolator.regular(dims, starts, steps, vals, method="linear")
    o_d = tuple(jax.device_put(o) for o in obs)
    idx_d, c_d = jax.device_put(idx), jax.device_put(c)
    grad = jax.jit(jax.grad(lambda m, o, i, w: jnp.sum(w * m(o)[i])))
    g, t1, t2 = _first_and_second(lambda: grad(itp, o_d, idx_d, c_d).vals)
    g = np.asarray(g)
    for trial in range(2):
        v = rng.standard_normal(vals.size)
        want = sum(
            ci * oracle.linear_regular(list(dims), starts, steps, v, [o[i] for o in obs])
            for ci, i in zip(c, idx)
        )
        scale = float(np.abs(c).sum() * np.abs(v).max())
        _report("gradients", f"grad wrt table linear f64 probe {trial}",
                np.array([g @ v]), np.array([want]), scale, TOL_F64)
    return max(t1 - t2, 0.0)


def phase_aot(sizes, rng, platforms=("cuda",)):
    """aot.export_eval for `platforms`, load, evaluate: equal to the
    model's direct evaluation."""
    import jax

    import interpn_tpu as it
    from interpn_tpu import aot

    n_axis = sizes.ext_table
    dims = [n_axis] * 3
    grids = [_regular_axis(n_axis) for _ in range(3)]
    vals = _table(dims, rng)
    model = it.MulticubicRegular.new(
        dims, np.zeros(3), np.full(3, grids[0][1] - grids[0][0]), vals
    )
    obs = [jax.device_put(o) for o in _queries(grids, sizes.ext_n, rng)]
    t0 = time.perf_counter()
    served = aot.load(aot.export_eval(model, [sizes.ext_n], platforms=list(platforms)))
    out, t1, t2 = _first_and_second(lambda: served.eval_jax(obs))
    direct = np.asarray(model.eval_jax(obs))
    out = np.asarray(out)
    print(f"phase aot: bitwise equal to the direct call: "
          f"{bool(np.array_equal(out, direct))}", flush=True)
    _report("aot", f"export {list(platforms)} cubic f64 n={sizes.ext_n}",
            out, direct, float(np.abs(vals).max()), TOL_F64)
    return time.perf_counter() - t0 - 2 * t2


def phase_classes(sizes, rng):
    """The class path: .eval_jax on device arrays and .eval(obs, out) with
    numpy, against the oracle."""
    import jax

    import interpn_tpu as it

    n_axis = sizes.ext_table
    grids = [_rect_axis(n_axis, rng) for _ in range(3)]
    vals = _table([n_axis] * 3, rng)
    obs = _queries(grids, sizes.core_n, rng)
    idx = rng.choice(sizes.core_n, min(sizes.sample, sizes.core_n), replace=False)
    model = it.MulticubicRectilinear.new(grids, vals)
    o_d = [jax.device_put(o) for o in obs]
    out_j, t1, t2 = _first_and_second(lambda: model.eval_jax(o_d))
    ref = _oracle("cubic", grids, False, vals, obs, idx)
    scale = float(np.abs(vals).max())
    _report("classes", f"MulticubicRectilinear.eval_jax f64 n={sizes.core_n}",
            np.asarray(out_j)[idx], ref, scale, TOL_F64)
    with _env(INTERPN_TPU_NATIVE="0"):
        out = np.zeros(sizes.core_n)
        ret = model.eval(obs, out)
    if ret is not out:
        raise PhaseFailure("classes: eval(obs, out) did not return out")
    _report("classes", f"MulticubicRectilinear.eval(obs, out) f64 n={sizes.core_n}",
            out[idx], ref, scale, TOL_F64)
    return max(t1 - t2, 0.0)


def phase_timings(sizes, rng):
    """Informational: steady-state medians, gather vs forced factorized,
    native vs device for host data, peak device memory. The factorized
    results are also checked against the gather tree's."""
    import jax

    from interpn_tpu import raw
    from interpn_tpu.functional import JaxInterpolator

    def median_s(fn):
        jax.block_until_ready(fn())
        ts = []
        for _ in range(sizes.timing_reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    n = sizes.core_n
    n_axis = sizes.core_tables[0]
    grids = [_regular_axis(n_axis) for _ in range(3)]
    dims = (n_axis,) * 3
    vals = _table(dims, rng)
    obs = _queries(grids, n, rng)
    step = grids[0][1] - grids[0][0]
    for dtype in (np.float32, np.float64):
        o_d = tuple(jax.device_put(o.astype(dtype)) for o in obs)
        for method in ("linear", "cubic"):
            res = {}
            for impl in ("gather", "factorized"):
                with _env(INTERPN_TPU_IMPL=impl):
                    itp = JaxInterpolator.regular(
                        dims, np.zeros(3, dtype), np.full(3, step, dtype),
                        vals.astype(dtype), method=method,
                    )
                    f = jax.jit(lambda o, itp=itp: itp(o))  # traced under impl
                    res[impl] = (median_s(lambda: f(o_d)), np.asarray(f(o_d)))
            t_g, t_f = res["gather"][0], res["factorized"][0]
            print(f"timing: {method} {np.dtype(dtype).name} {n_axis}^3 n={n} "
                  f"gather_median_s={t_g:.6f} ({n / t_g:.4e} q/s) "
                  f"factorized_median_s={t_f:.6f} ({n / t_f:.4e} q/s) "
                  f"factorized/gather={t_f / t_g:.3f}", flush=True)
            _report("timing", f"factorized vs gather {method} {np.dtype(dtype).name}",
                    res["factorized"][1], res["gather"][1],
                    float(np.abs(vals).max()), _tol(dtype))

    # host numpy data through the raw API: native C++ vs the device
    out = np.zeros(n)
    starts, steps = np.zeros(3), np.full(3, step)
    call = lambda: raw.interpn_linear_regular_f64(
        np.array(dims), starts, steps, vals, obs, out
    )
    t_native = median_s(call)
    with _env(INTERPN_TPU_NATIVE="0"):
        t_device = median_s(call)
    from interpn_tpu import native

    print(f"timing: host-numpy linear f64 n={n} native_median_s={t_native:.6f} "
          f"device_median_s={t_device:.6f} native_built={native.available()}",
          flush=True)
    stats = jax.devices()[0].memory_stats() or {}
    print(f"timing: peak_bytes_in_use={stats.get('peak_bytes_in_use', 'n/a')}",
          flush=True)
    return 0.0


# ---------------------------------------------------------------------------
# Four cards: the sharded path and what it is compared with
# ---------------------------------------------------------------------------

COLLECTIVES = ("all-reduce", "all-gather", "collective-permute",
               "reduce-scatter", "all-to-all")


def _check_sharded(label, f_mesh, f_one, args, one_args, n_dev, exact, scale, tol):
    """Output sharding over n_dev devices, no collective in the compiled
    HLO, and the same values as the one-device call."""
    import jax
    from jax.sharding import PartitionSpec as P

    out = f_mesh(*args)
    if out.sharding.spec not in (P("obs"), P(None, "obs")):
        raise PhaseFailure(f"{label}: output spec {out.sharding.spec}")
    if len(out.sharding.device_set) != n_dev:
        raise PhaseFailure(f"{label}: output on {len(out.sharding.device_set)} devices")
    hlo = jax.jit(f_mesh).lower(*args).compile().as_text()
    found = [c for c in COLLECTIVES if c in hlo]
    if found:
        raise PhaseFailure(f"{label}: collectives in HLO: {found}")
    ref = f_one(*one_args)
    _report("multichip", f"{label} spec={out.sharding.spec} devices={n_dev} "
            f"collectives=none", np.asarray(out), np.asarray(ref), scale, tol,
            exact=exact)


def phase_multichip(sizes, rng, n_dev=4):
    """parallel.sharded_evaluator for every method x grid kind x dtype,
    prepared_evaluator (pchip, cubic_spline) and prepared_stack_evaluator
    on an n_dev mesh, each against the same call on jax.devices()[0]."""
    import jax

    from interpn_tpu import parallel

    devs = jax.devices()
    if len(devs) < n_dev:
        raise PhaseFailure(f"multichip needs {n_dev} devices, found {len(devs)}")
    mesh = parallel.make_mesh(devs[:n_dev])
    one = parallel.make_mesh(devs[:1])
    n = sizes.shard_n - sizes.shard_n % n_dev
    n_axis = sizes.ext_table
    dims = (n_axis,) * 3
    reg = [_regular_axis(n_axis) for _ in range(3)]
    rect = [_rect_axis(n_axis, rng) for _ in range(3)]
    vals = _table(dims, rng)
    scale = float(np.abs(vals).max())
    for regular in (True, False):
        grids = reg if regular else rect
        obs = _queries(grids, n, rng)
        for dtype in (np.float32, np.float64):
            v = vals.astype(dtype)
            garrs = ((np.zeros(3, dtype), np.full(3, reg[0][1] - reg[0][0], dtype))
                     if regular else tuple(g.astype(dtype) for g in grids))
            o = [x.astype(dtype) for x in obs]
            o_mesh = parallel.shard_obs(o, mesh)
            o_one = parallel.shard_obs(o, one)
            for method in ("linear", "cubic", "nearest"):
                fm = parallel.sharded_evaluator(mesh, method=method, regular=regular)
                f1 = parallel.sharded_evaluator(one, method=method, regular=regular)
                kw = {"dims": dims} if regular else {}
                _check_sharded(
                    f"sharded_evaluator {method} {'regular' if regular else 'rectilinear'} "
                    f"{np.dtype(dtype).name} n={n}",
                    lambda *a, fm=fm, kw=kw: fm(*a, **kw),
                    lambda *a, f1=f1, kw=kw: f1(*a, **kw),
                    (garrs, v, o_mesh), (garrs, v, o_one), n_dev,
                    method == "nearest", scale, _tol(dtype),
                )
    obs = _queries(reg, n, rng)
    o_mesh = parallel.shard_obs(obs, mesh)
    o_one = parallel.shard_obs(obs, one)
    st = (np.zeros(3), np.full(3, reg[0][1] - reg[0][0]))
    for method in ("pchip", "cubic_spline"):
        fm = parallel.prepared_evaluator(mesh, st, vals, dims=dims, method=method)
        f1 = parallel.prepared_evaluator(one, st, vals, dims=dims, method=method)
        _check_sharded(f"prepared_evaluator {method} f64 n={n}", fm, f1,
                       (o_mesh,), (o_one,), n_dev, False, scale, TOL_F64)
    stack = rng.standard_normal((sizes.stack_channels, vals.size)).astype(np.float32)
    o32 = parallel.shard_obs([x.astype(np.float32) for x in obs], mesh)
    o32_one = parallel.shard_obs([x.astype(np.float32) for x in obs], one)
    st32 = tuple(a.astype(np.float32) for a in st)
    fm = parallel.prepared_stack_evaluator(mesh, st32, stack, dims=dims, method="linear")
    f1 = parallel.prepared_stack_evaluator(one, st32, stack, dims=dims, method="linear")
    _check_sharded(f"prepared_stack_evaluator linear f32 {sizes.stack_channels}ch n={n}",
                   fm, f1, (o32,), (o32_one,), n_dev, False,
                   float(np.abs(stack).max()), TOL_F32)
    return 0.0


# ---------------------------------------------------------------------------


def _run_phases(phases, sizes):
    failed = []
    for name, fn in phases:
        rng = np.random.default_rng(0)  # each phase makes its data from one seed
        t0 = time.perf_counter()
        try:
            compile_s = fn(sizes, rng)
            print(f"phase {name}: done wall_s={time.perf_counter() - t0:.2f} "
                  f"compile_s={compile_s:.2f}", flush=True)
        except Exception:  # noqa: BLE001 - every phase reports, the run fails
            traceback.print_exc()
            print(f"phase {name}: FAILED", flush=True)
            failed.append(name)
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the sharded path on four GPUs")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's first device is {devs[0].platform}",
              file=sys.stderr)
        return 2

    from interpn_tpu.utils.profiling import card_info

    print(card_info(), flush=True)
    print(f"jax {jax.__version__}", flush=True)
    print(f"compilation cache: {jax.config.jax_compilation_cache_dir}", flush=True)
    print(f"devices: {len(devs)} x {devs[0].device_kind}", flush=True)

    if args.multichip:
        phases = [("multichip", phase_multichip)]
    else:
        from importlib.util import find_spec

        phases = [
            ("core", phase_core), ("big_table", phase_big_table),
            ("high_dim", phase_high_dim), ("extensions", phase_extensions),
            ("compat", phase_compat), ("gradients", phase_gradients),
        ]
        # the model classes need pydantic, and jax.export serialization
        # needs flatbuffers; neither is a dependency of this package
        if find_spec("pydantic") is None:
            print("phases aot and classes: not run (pydantic not importable)",
                  flush=True)
        else:
            phases.append(("classes", phase_classes))
            if find_spec("flatbuffers") is None:
                print("phase aot: not run (flatbuffers not importable; "
                      "jax.export serialization needs it)", flush=True)
            else:
                phases.append(("aot", phase_aot))
            print("phase classes: run (pydantic importable)", flush=True)
        phases.append(("timings", phase_timings))
    failed = _run_phases(phases, FULL)
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
