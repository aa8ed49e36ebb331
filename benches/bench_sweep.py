"""Throughput sweeps vs scipy, mirroring the reference's benches/bench_cpu.py.

Produces the reference's published figure families (`docs/perf.md` artifacts,
reference `benches/bench_cpu.py:928-1010` / `:652-860` configs), extended to
the device path:

* speedup vs dims (host path): 4-points-per-axis grids, 1-6 dimensions,
  nobs in {1, 1000}, linear + cubic + nearest, regular AND rectilinear,
  against scipy RegularGridInterpolator (same method).
* device throughput vs dims: same grids, 1e6 device-resident f32 queries
  per dimension count.
* throughput vs nobs (host path): 3D and 4D 20-points-per-axis grids,
  nobs from 1 to 1e6, preallocated output.

Results print as tables, dump to benches/sweep_results.json, and render
SVGs into docs/. The host side uses the public dispatch policy (native CPU
engine for host data); the device side times `eval_jax` on device arrays
with the scan timer (utils/profiling.device_timeit).

Set INTERPN_TPU_BENCH_ONLY=1 to skip the scipy baselines (the reference's
INTERPNPY_INTERPN_ONLY analogue). Run:

    python benches/bench_sweep.py [--quick] [--host-only] [--device-only]
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

import interpn_tpu as it

RUN_INTERPN_ONLY = os.environ.get("INTERPN_TPU_BENCH_ONLY", "") in ("1", "true")
DOCS = Path(__file__).resolve().parent.parent / "docs"
HERE = Path(__file__).resolve().parent

# Figure palette: the dataviz reference categorical slots 1-3 (validated
# order blue/orange/aqua); method = hue, grid kind = line style.
METHOD_COLOR = {"linear": "#2a78d6", "cubic": "#eb6834", "nearest": "#1baf7a"}
KIND_STYLE = {"regular": "-", "rectilinear": "--"}
TEXT_PRIMARY = "#0b0b0b"
TEXT_SECONDARY = "#52514e"
SURFACE = "#fcfcfb"


def average_call_time(func, target_seconds: float = 0.3) -> float:
    """Average wall time of func() over ~target_seconds of samples."""
    func()  # warm (compile / cache)
    gc.collect()
    t0 = time.perf_counter()
    func()
    once = max(time.perf_counter() - t0, 1e-7)
    iters = max(1, min(100_000, int(target_seconds / once)))
    gc.collect()
    t0 = time.perf_counter()
    for _ in range(iters):
        func()
    return (time.perf_counter() - t0) / iters


def _axes_for(ndims, npts, kind, dtype=np.float64, seed=0):
    if kind == "regular":
        return [np.linspace(0.0, 1.0, npts).astype(dtype) for _ in range(ndims)]
    rng = np.random.default_rng(seed + ndims)
    return [
        np.sort(rng.uniform(0.0, 1.0, npts)).astype(dtype) for _ in range(ndims)
    ]


def _vals_for(axes, dtype=np.float64):
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.sum(np.stack([np.sin(3 * m) for m in mesh]), axis=0).astype(dtype)


def _interpolator(axes, vals, method, kind):
    dims = [len(a) for a in axes]
    flat = vals.ravel()
    if method == "cubic" and min(dims) < 4:
        return None
    if method == "nearest" and len(dims) > 6:
        return None
    if kind == "regular":
        starts = np.array([a[0] for a in axes], dtype=flat.dtype)
        steps = np.array([a[1] - a[0] for a in axes], dtype=flat.dtype)
        cls = {
            "linear": it.MultilinearRegular,
            "cubic": it.MulticubicRegular,
            "nearest": it.NearestRegular,
        }[method]
        return cls.new(dims, starts, steps, flat)
    cls = {
        "linear": it.MultilinearRectilinear,
        "cubic": it.MulticubicRectilinear,
        "nearest": it.NearestRectilinear,
    }[method]
    return cls.new(list(axes), flat)


def sweep_vs_dims(max_dims=6, nobs_list=(1, 1000)):
    """Host-path speedups vs scipy RGI (same method), per grid kind."""
    print("== host speedup vs dims (4-point axes) ==", flush=True)
    rows = {}
    for nobs in nobs_list:
        for ndims in range(1, max_dims + 1):
            rng = np.random.default_rng(1)
            obs = [rng.uniform(-0.2, 1.2, nobs) for _ in range(ndims)]
            out = np.zeros(nobs)
            for kind in ("regular", "rectilinear"):
                axes = _axes_for(ndims, 4, kind)
                vals = _vals_for(axes)
                pts = np.stack(obs, axis=-1)
                for method in ("linear", "cubic", "nearest"):
                    interp = _interpolator(axes, vals, method, kind)
                    if interp is None:
                        continue
                    t = average_call_time(lambda: interp.eval(obs, out))
                    scipy_t = None
                    if not RUN_INTERPN_ONLY:
                        from scipy.interpolate import RegularGridInterpolator

                        rgi = RegularGridInterpolator(
                            axes, vals, method=method,
                            bounds_error=False, fill_value=None,
                        )
                        scipy_t = average_call_time(lambda: rgi(pts))
                    speedup = (scipy_t / t) if scipy_t else float("nan")
                    rows[(method, kind, nobs, ndims)] = (nobs / t, speedup)
                    print(
                        f"  {method:8s} {kind:11s} {ndims}D nobs={nobs:<6d}"
                        f" {nobs/t/1e6:9.3f} Mq/s   vs scipy: {speedup:8.1f}x",
                        flush=True,
                    )
    return rows


def sweep_vs_dims_device(max_dims=6, n=1_000_000, reps=4):
    """Device-path throughput at 1e6 f32 queries per dimension count."""
    import jax

    if jax.devices()[0].platform != "gpu":
        print("== no GPU; skipping the device sweep ==", flush=True)
        return {}
    import jax.numpy as jnp

    from interpn_tpu.utils.profiling import device_timeit

    print(f"== device throughput vs dims (4-point axes, {n} f32 queries) ==",
          flush=True)
    rows = {}
    for ndims in range(1, max_dims + 1):
        rng = np.random.default_rng(2)
        obs_sets = jnp.asarray(
            rng.uniform(-0.2, 1.2, (reps, ndims, n)).astype(np.float32)
        )
        for kind in ("regular", "rectilinear"):
            axes = _axes_for(ndims, 4, kind, dtype=np.float32)
            vals = _vals_for(axes, dtype=np.float32)
            for method in ("linear", "cubic", "nearest"):
                interp = _interpolator(axes, vals, method, kind)
                if interp is None:
                    continue
                t = device_timeit(lambda ob: interp.eval_jax(ob), obs_sets)
                rows[(method, kind, ndims)] = n / t
                print(
                    f"  {method:8s} {kind:11s} {ndims}D"
                    f" {n/t/1e6:9.1f} Mq/s",
                    flush=True,
                )
    return rows


def sweep_vs_nobs(ndims_list=(3, 4), ns=(1, 10, 100, 1000, 10_000, 100_000, 1_000_000)):
    """Both published reference configurations (docs/3d_throughput_vs_nobs_
    *.html): `prealloc` passes a caller-owned `out` (zero allocations per
    eval — the reference's headline family), `alloc` calls `eval(obs)` and
    pays a fresh output allocation per call (the reference's second
    family; VERDICT r4 missing #3)."""
    print("== host throughput vs nobs (20-point axes) ==", flush=True)
    rows = {}
    for ndims in ndims_list:
        axes = _axes_for(ndims, 20, "regular")
        vals = _vals_for(axes)
        rng = np.random.default_rng(2)
        for n in ns:
            obs = [rng.uniform(-0.2, 1.2, n) for _ in range(ndims)]
            out = np.zeros(n)
            for method in ("linear", "cubic"):
                interp = _interpolator(axes, vals, method, "regular")
                for mode in ("prealloc", "alloc"):
                    call = (
                        (lambda: interp.eval(obs, out))
                        if mode == "prealloc"
                        else (lambda: interp.eval(obs))
                    )
                    t = average_call_time(call, 0.5)
                    rows[(method, ndims, n, mode)] = n / t
                    print(
                        f"  {method:8s} {ndims}D nobs={n:<8d} {mode:9s}"
                        f" {n/t/1e6:9.3f} Mq/s",
                        flush=True,
                    )
    return rows


def _style_ax(ax):
    ax.set_facecolor(SURFACE)
    ax.grid(True, which="both", alpha=0.25, linewidth=0.6)
    ax.tick_params(colors=TEXT_SECONDARY, labelsize=9)
    for spine in ax.spines.values():
        spine.set_color(TEXT_SECONDARY)
        spine.set_linewidth(0.6)
    ax.xaxis.label.set_color(TEXT_PRIMARY)
    ax.yaxis.label.set_color(TEXT_PRIMARY)
    ax.title.set_color(TEXT_PRIMARY)


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except ImportError:
        return None


def plot_vs_dims(rows, nobs, path: Path, value="speedup"):
    plt = _plt()
    if plt is None or not rows:
        return
    fig, ax = plt.subplots(figsize=(6.5, 4), constrained_layout=True)
    fig.patch.set_facecolor(SURFACE)
    for method in ("linear", "cubic", "nearest"):
        for kind in ("regular", "rectilinear"):
            pts = sorted(
                (nd, v[1] if value == "speedup" else v[0] / 1e6)
                for (m, k, no, nd), v in rows.items()
                if m == method and k == kind and no == nobs and np.isfinite(
                    v[1] if value == "speedup" else v[0]
                )
            )
            if not pts:
                continue
            ax.semilogy(
                [p[0] for p in pts], [p[1] for p in pts],
                KIND_STYLE[kind], marker="o", markersize=4, linewidth=2,
                color=METHOD_COLOR[method],
                label=f"{method}, {kind}",
            )
    ax.set_xlabel("dimensions")
    ax.set_ylabel(
        "speedup over scipy (x)" if value == "speedup" else "Mqueries/sec"
    )
    ax.set_title(f"4x...x4 N-dimensional grid, {nobs} observation point(s)")
    ax.axhline(1.0, color=TEXT_SECONDARY, linewidth=0.8, alpha=0.6)
    _style_ax(ax)
    ax.legend(fontsize=8, framealpha=0.9)
    path.parent.mkdir(exist_ok=True)
    fig.savefig(path)
    print(f"wrote {path}", flush=True)


def plot_device_vs_dims(rows, path: Path, n=1_000_000):
    plt = _plt()
    if plt is None or not rows:
        return
    fig, ax = plt.subplots(figsize=(6.5, 4), constrained_layout=True)
    fig.patch.set_facecolor(SURFACE)
    for method in ("linear", "cubic", "nearest"):
        for kind in ("regular", "rectilinear"):
            pts = sorted(
                (nd, q / 1e6)
                for (m, k, nd), q in rows.items()
                if m == method and k == kind
            )
            if not pts:
                continue
            ax.semilogy(
                [p[0] for p in pts], [p[1] for p in pts],
                KIND_STYLE[kind], marker="o", markersize=4, linewidth=2,
                color=METHOD_COLOR[method], label=f"{method}, {kind}",
            )
    ax.set_xlabel("dimensions")
    ax.set_ylabel("Mqueries/sec")
    import jax

    ax.set_title(f"{jax.devices()[0].device_kind}, 4x...x4 grid, {n:,} f32 queries")
    _style_ax(ax)
    ax.legend(fontsize=8, framealpha=0.9)
    path.parent.mkdir(exist_ok=True)
    fig.savefig(path)
    print(f"wrote {path}", flush=True)


def plot_vs_nobs(rows_nobs, path: Path):
    plt = _plt()
    if plt is None or not rows_nobs:
        return
    fig, axs = plt.subplots(1, 2, figsize=(11, 4), constrained_layout=True)
    fig.patch.set_facecolor(SURFACE)
    for ax, ndims in zip(axs, (3, 4)):
        for method in ("linear", "cubic"):
            for mode, style in (("prealloc", "-"), ("alloc", "--")):
                pts = sorted(
                    (k[2], q) for k, q in rows_nobs.items()
                    if k[0] == method and k[1] == ndims
                    and (len(k) < 4 or k[3] == mode)
                )
                if not pts:
                    continue
                ax.loglog(
                    [p[0] for p in pts], [p[1] for p in pts],
                    style, marker="o", markersize=4, linewidth=2,
                    color=METHOD_COLOR[method],
                    label=f"{method} ({mode})",
                )
        ax.set_xlabel("observation points")
        ax.set_ylabel("queries/sec")
        ax.set_title(f"{ndims}D, 20 pts/axis, prealloc vs alloc-at-eval")
        _style_ax(ax)
        ax.legend(fontsize=8, framealpha=0.9)
    path.parent.mkdir(exist_ok=True)
    fig.savefig(path)
    print(f"wrote {path}", flush=True)


def _dump(results):
    path = HERE / "sweep_results.json"
    enc = {}
    if path.exists():  # partial runs (--host-only / --device-only) merge
        enc = json.loads(path.read_text())
    for section, rows in results.items():
        enc[section] = {"|".join(map(str, k)): v for k, v in rows.items()}
    path.write_text(json.dumps(enc, indent=1))
    print(f"wrote {path}", flush=True)


if __name__ == "__main__":
    quick = "--quick" in sys.argv
    host_only = "--host-only" in sys.argv
    device_only = "--device-only" in sys.argv
    max_dims = 4 if quick else 6
    results = {}
    if not device_only:
        results["host_vs_dims"] = sweep_vs_dims(max_dims=max_dims)
        plot_vs_dims(results["host_vs_dims"], 1, DOCS / "speedup_vs_dims_1_obs.svg")
        plot_vs_dims(
            results["host_vs_dims"], 1000, DOCS / "speedup_vs_dims_1000_obs.svg"
        )
        results["host_vs_nobs"] = sweep_vs_nobs(
            ns=(1, 1000, 100_000) if quick
            else (1, 10, 100, 1000, 10_000, 100_000, 1_000_000)
        )
        plot_vs_nobs(results["host_vs_nobs"], DOCS / "throughput_vs_nobs.svg")
    if not host_only:
        results["device_vs_dims"] = sweep_vs_dims_device(max_dims=max_dims)
        plot_device_vs_dims(
            results["device_vs_dims"], DOCS / "device_throughput_vs_dims_1m.svg"
        )
    _dump(results)
