"""Benchmark harness: one JSON line.

Headline metric: 3D regular-grid multilinear f32 throughput (queries/sec) at
1e6 device-resident observation points on one GPU — the configuration the
reference's own headline numbers target (BASELINE.md, 3D prealloc rows).
The run fails when JAX finds no GPU; it never falls back to the CPU. It
prints the device (`platform`, `device_kind`, count) and the card's name and
power limit as `nvidia-smi` reports them.

Methodology notes:
* Each timed run `lax.scan`s the kernel over R DISTINCT observation sets
  inside one jit, generated on the device: this amortizes host dispatch,
  and distinct inputs keep a runtime that caches execution results from
  timing a cache hit.
* Baseline derivation: the reference publishes only speedups over scipy's
  RegularGridInterpolator measured on its author's CPU. We measure scipy RGI
  f64 on THIS host for the same 20^3-grid workload and multiply by the
  reference's published 3D-linear prealloc speedup at its largest published
  size (11.2x @ 10k obs, BASELINE.md). vs_baseline = ours / that estimate.

`python bench.py --full` also prints a per-config table (method x dtype x
size, plus the native CPU small-batch path) to stderr, and `--out PATH`
writes it as JSON.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

GRID_N = 20
N_OBS = 1_000_000
# Evaluations per timed scan (R x ndims x N_OBS stacks live on the device).
R = 16
SCIPY_SPEEDUP_3D_LINEAR = 11.2  # BASELINE.md: 3D linear prealloc @ 10k obs


def _grid_host(ndims, grid_n=GRID_N):
    x = np.linspace(0.0, 10.0, grid_n)
    mesh = np.meshgrid(*([x] * ndims), indexing="ij")
    vals_np = np.sin(mesh[0])
    for m in mesh[1:]:
        vals_np = vals_np + m * 0.37
    return x, vals_np


def _grid(ndims, dtype, grid_n=GRID_N):
    import jax.numpy as jnp

    x, vals_np = _grid_host(ndims, grid_n)
    starts = jnp.zeros(ndims, dtype=dtype)
    steps = jnp.full(ndims, x[1] - x[0], dtype=dtype)
    vals = jnp.asarray(vals_np.ravel(), dtype=dtype)
    return x, vals_np, starts, steps, vals


def _rect_grids_host(ndims, seed=5, grid_n=GRID_N):
    """Strictly-monotonic non-uniform axes over the same [0, 10] span (so
    the shared on-device obs generator covers interior + extrapolation)."""
    rng = np.random.default_rng(seed)
    grids = []
    for _ in range(ndims):
        g = np.linspace(0.0, 10.0, grid_n)
        g[1:-1] += rng.uniform(-0.3, 0.3, grid_n - 2) * (g[1] - g[0])
        grids.append(np.sort(g))
    x, vals_np = _grid_host(ndims, grid_n)
    return grids, vals_np


def _obs_stack(ndims, n, dtype, seed=0):
    """One (R, ndims, n) stack of query coordinates, generated on the
    device (jax.random: only a key crosses from the host)."""
    import jax
    import jax.numpy as jnp

    gen = jax.jit(
        lambda key: jax.random.uniform(
            key, (R, ndims, n), dtype, minval=-0.5, maxval=10.5
        )
    )
    return jax.block_until_ready(gen(jax.random.PRNGKey(seed)))


def _scan_time(kernel, ndims, n, dtype, seeds=(0, 1, 2)):
    """Seconds per evaluation of `kernel` over one (ndims, n) obs set.

    Takes the best of several timed scans over DISTINCT input stacks (each
    timed quantity is itself an R-evaluation average). Stacks are generated
    on the device one at a time."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(obs_stack):
        def body(acc, ob):
            out = kernel(tuple(ob))
            # full reduction: a sliced reduction would let XLA dead-code
            # eliminate the work being timed
            return acc + jnp.sum(out), None

        acc, _ = jax.lax.scan(body, jnp.zeros((), obs_stack.dtype), obs_stack)
        return acc

    best = float("inf")
    for i, seed in enumerate(seeds):
        t_gen = time.perf_counter()
        stack = _obs_stack(ndims, n, dtype, seed=seed)
        print(f"#   stack {seed}: gen {time.perf_counter() - t_gen:.1f}s",
              file=sys.stderr, flush=True)
        if i == 0:
            t_c = time.perf_counter()
            jax.block_until_ready(run(stack))  # compile + warm
            print(f"#   compile+warm {time.perf_counter() - t_c:.1f}s",
                  file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        r = run(stack)
        jax.block_until_ready(r)
        best = min(best, (time.perf_counter() - t0) / R)
        del stack, r
    return best


def bench_device(method: str, dtype_name: str, ndims: int = 3,
                 n_obs: int = N_OBS, grid_n: int = GRID_N):
    """Queries/sec for the device path via the dispatching ops API."""
    import jax.numpy as jnp

    from interpn_tpu import ops

    dtype = {"f32": jnp.float32, "f64": jnp.float64}[dtype_name]
    _, _, starts, steps, vals = _grid(ndims, dtype, grid_n)
    dims = (grid_n,) * ndims

    kern = {
        "linear": lambda o: ops.linear_regular(dims, starts, steps, vals, o),
        "cubic": lambda o: ops.cubic_regular(dims, starts, steps, vals, o, True),
        "nearest": lambda o: ops.nearest_regular(dims, starts, steps, vals, o),
    }[method]
    dt = _scan_time(kern, ndims, n_obs, dtype)
    return n_obs / dt


def bench_spline_device(ndims: int = 3, n_obs: int = N_OBS, dtype_name="f32",
                        grid_n: int = GRID_N):
    """Queries/sec for the global cubic B-spline."""
    import jax.numpy as jnp

    from interpn_tpu.ops import bspline

    dtype = {"f32": jnp.float32, "f64": jnp.float64}[dtype_name]
    x, vals_np = _grid_host(ndims, grid_n)
    knots, coeffs = bspline.prep_bspline([x] * ndims, vals_np.ravel(), 3)
    kt = tuple(jnp.asarray(t, dtype) for t in knots)
    cf = jnp.asarray(coeffs, dtype)
    dt = _scan_time(
        lambda o: bspline.bspline_eval(kt, cf, o, 3), ndims, n_obs, dtype
    )
    return n_obs / dt


def bench_device_rect(method: str, dtype_name: str, ndims: int = 3,
                      n_obs: int = N_OBS, grid_n: int = GRID_N):
    """Queries/sec for the rectilinear device path via the dispatching ops
    API."""
    import jax.numpy as jnp

    from interpn_tpu import ops

    dtype = {"f32": jnp.float32, "f64": jnp.float64}[dtype_name]
    grids_np, vals_np = _rect_grids_host(ndims, grid_n=grid_n)
    grids = tuple(jnp.asarray(g, dtype) for g in grids_np)
    vals = jnp.asarray(vals_np.ravel(), dtype)
    kern = {
        "linear": lambda o: ops.linear_rectilinear(grids, vals, o),
        "cubic": lambda o: ops.cubic_rectilinear(grids, vals, o, True),
    }[method]
    dt = _scan_time(kern, ndims, n_obs, dtype)
    return n_obs / dt


def bench_pchip_device(ndims: int = 3, n_obs: int = N_OBS):
    """Queries/sec for the pchip extension method (f64)."""
    import jax.numpy as jnp

    from interpn_tpu import ops

    _, _, starts, steps, vals = _grid(ndims, jnp.float64)
    dims = (GRID_N,) * ndims
    dt = _scan_time(
        lambda o: ops.pchip_regular(dims, starts, steps, vals, o),
        ndims, n_obs, jnp.float64,
    )
    return n_obs / dt


def bench_one_dim_device(n_obs: int = N_OBS):
    """Queries/sec for the one_dim fast-path family (Linear1D, regular)."""
    import jax.numpy as jnp

    from interpn_tpu.ops import one_dim

    x = np.linspace(0.0, 10.0, 1000)
    itp = one_dim.Linear1D(
        one_dim.RegularGrid1D(
            jnp.float32(0.0), jnp.float32(x[1] - x[0]),
            jnp.asarray(np.sin(x), jnp.float32),
        )
    )
    dt = _scan_time(lambda o: itp._eval(o[0]), 1, n_obs, jnp.float32)
    return n_obs / dt


def bench_stack_device(nch: int = 8, ndims: int = 3, n_obs: int = N_OBS):
    """Channel-queries/sec for an nch-table stack on one grid."""
    import jax.numpy as jnp

    from interpn_tpu import ops

    x, vals_np = _grid_host(ndims)
    vals = jnp.asarray(
        np.stack([vals_np.ravel() + i for i in range(nch)]), jnp.float32
    )
    dims = (GRID_N,) * ndims
    starts = jnp.zeros(ndims, jnp.float32)
    steps = jnp.full(ndims, x[1] - x[0], jnp.float32)
    dt = _scan_time(
        lambda o: ops.linear_regular_stack(dims, starts, steps, vals, o),
        ndims, n_obs, jnp.float32,
    )
    return n_obs * nch / dt


def bench_native(method: str, n_obs: int, ndims: int = 3):
    """Queries/sec for the native CPU path (f64, preallocated out)."""
    from interpn_tpu import native

    if not native.available():
        return None
    x, vals_np = _grid_host(ndims)
    rng = np.random.default_rng(1)
    obs = [rng.uniform(-0.5, 10.5, n_obs) for _ in range(ndims)]
    out = np.zeros(n_obs)
    dims = [GRID_N] * ndims
    starts = np.zeros(ndims)
    steps = np.full(ndims, x[1] - x[0])
    call = {
        "linear": lambda: native.linear_regular(dims, starts, steps, vals_np.ravel(), obs, out),
        "cubic": lambda: native.cubic_regular(dims, starts, steps, vals_np.ravel(), True, obs, out),
        "nearest": lambda: native.nearest_regular(dims, starts, steps, vals_np.ravel(), obs, out),
    }[method]
    call()
    iters = max(3, int(2e6 / max(n_obs, 1)))
    t0 = time.perf_counter()
    for _ in range(iters):
        call()
    return n_obs * iters / (time.perf_counter() - t0)


def scipy_baseline_qps() -> float:
    from scipy.interpolate import RegularGridInterpolator

    x, vals_np = _grid_host(3)
    rgi = RegularGridInterpolator(
        (x, x, x), vals_np, method="linear", bounds_error=False, fill_value=None
    )
    rng = np.random.default_rng(2)
    pts = rng.uniform(-0.5, 10.5, (N_OBS, 3))
    rgi(pts[:1000])  # warm
    best = float("inf")
    for _ in range(3):  # best-of-3: host timing is contention-noisy
        t0 = time.perf_counter()
        rgi(pts)
        best = min(best, time.perf_counter() - t0)
    return N_OBS / best


def require_gpu():
    """The device list when JAX's first device is a GPU; exits otherwise."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX's first device is {devs[0].platform}")
    from interpn_tpu.utils.profiling import card_info

    print(f"# card: {card_info()}", file=sys.stderr)
    print(
        f"# device: platform={devs[0].platform} kind={devs[0].device_kind}"
        f" count={len(devs)}",
        file=sys.stderr,
    )
    return devs


def main():
    devs = require_gpu()
    full = "--full" in sys.argv
    qps = bench_device("linear", "f32")
    scipy_qps = scipy_baseline_qps()
    baseline = scipy_qps * SCIPY_SPEEDUP_3D_LINEAR

    if full:
        err = sys.stderr
        table: dict[str, object] = {}

        def row(name: str, qps):
            if qps:
                table[name] = qps / 1e6
                print(f"# {name}: {qps/1e6:9.3f} Mq/s", file=err, flush=True)

        for method in ("linear", "cubic", "nearest"):
            for dt in ("f32", "f64"):
                row(f"device_{method}_{dt}_3d@1M", bench_device(method, dt))
        for method in ("linear", "cubic"):
            row(f"device_{method}_f32_4d@1M", bench_device(method, "f32", ndims=4))
        row("device_cubic_f64_4d@1M", bench_device("cubic", "f64", ndims=4))
        row("device_cubic_f64_5d12@1M",
            bench_device("cubic", "f64", ndims=5, grid_n=12))
        for method in ("linear", "cubic"):
            row(f"device_{method}_rect_f32_3d@1M", bench_device_rect(method, "f32"))
        row("device_cubic_rect_f64_3d@1M", bench_device_rect("cubic", "f64"))
        # >64-point axes: the compare_all searchsorted + one-hot take regime
        row("device_cubic_rect_f32_3d100@1M",
            bench_device_rect("cubic", "f32", grid_n=100))
        row("device_cubic_spline_f32_3d@1M", bench_spline_device())
        row("device_cubic_spline_f64_3d@1M", bench_spline_device(dtype_name="f64"))
        row("device_cubic_spline_f64_2d100@1M",
            bench_spline_device(ndims=2, dtype_name="f64", grid_n=100))
        row("device_pchip_f64_3d@1M", bench_pchip_device())
        row("device_one_dim_linear_f32_1d@1M", bench_one_dim_device())
        # stacked-table evaluation: Mq/s counts queries x channels
        row("device_stack8_linear_f32_3d@1M", bench_stack_device())
        for method in ("linear", "cubic"):
            for n in (1, 1000):
                row(f"native_{method}_f64_3d@{n}", bench_native(method, n))
        row("scipy_rgi_linear_f64_3d@1M", scipy_qps)
        row("implied_reference_baseline", baseline)
        table["headline_qps"] = qps
        table["bench_R"] = R
        table["device_kind"] = devs[0].device_kind

        if "--out" in sys.argv:
            out_path = sys.argv[sys.argv.index("--out") + 1]
            table["timestamp"] = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
            with open(out_path, "w") as f:
                json.dump(table, f, indent=1, sort_keys=True)
            print(f"# wrote {out_path}", file=err)

    print(
        json.dumps(
            {
                "metric": "3d_linear_regular_f32_qps_1e6_obs",
                "value": qps,
                "unit": "queries/sec",
                "vs_baseline": qps / baseline,
                "device": {
                    "platform": devs[0].platform,
                    "kind": devs[0].device_kind,
                    "count": len(devs),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
