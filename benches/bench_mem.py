"""Memory behavior of the evaluation paths (reference: benches/bench_mem.py
with memory_profiler; here we report both host RSS and device memory stats).

Checks the no-realloc contract: repeated preallocated-output evals must not
grow host RSS or device memory.

Run: python benches/bench_mem.py
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

import interpn_tpu as it


def rss_mb() -> float:
    # Current (not peak) resident set, so repeated evals can be compared;
    # ru_maxrss is monotone and would report transient staging buffers as
    # growth.
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024
    return 0.0


def device_bytes():
    import jax

    stats = jax.local_devices()[0].memory_stats() or {}
    return stats.get("bytes_in_use", 0)


def main() -> None:
    rng = np.random.default_rng(0)
    axes = [np.linspace(0, 1, 20) for _ in range(3)]
    mesh = np.meshgrid(*axes, indexing="ij")
    vals = (mesh[0] + mesh[1] * mesh[2]).ravel()
    interp = it.MulticubicRegular.new(
        [20, 20, 20], np.zeros(3), np.full(3, axes[0][1]), vals
    )
    n = 200_000
    obs = [rng.uniform(-0.2, 1.2, n) for _ in range(3)]
    out = np.zeros(n)

    interp.eval(obs, out)  # compile + warm
    r0, d0 = rss_mb(), device_bytes()
    for _ in range(50):
        interp.eval(obs, out)
    r1, d1 = rss_mb(), device_bytes()
    print(f"host RSS: {r0:.1f} MB -> {r1:.1f} MB (delta {r1-r0:+.1f} MB over 50 evals)")
    print(f"device:   {d0/1e6:.1f} MB -> {d1/1e6:.1f} MB (delta {(d1-d0)/1e6:+.1f} MB)")
    assert r1 - r0 < 96, "host memory grew unexpectedly"
    if "--ram-vs-dims" in sys.argv:
        ram_vs_dims()


def ram_vs_dims(max_dims: int = 6):
    """RSS growth per interpolator construction + 1000-point eval, 1-6D
    (the reference's ram_vs_dims.svg analogue; 4-point axes)."""
    import gc

    rng = np.random.default_rng(1)
    rows = {"interpn-tpu": [], "scipy RGI": []}
    for ndims in range(1, max_dims + 1):
        axes = [np.linspace(0, 1, 4) for _ in range(ndims)]
        mesh = np.meshgrid(*axes, indexing="ij")
        vals = np.sum(np.stack(mesh), axis=0)
        obs = [rng.uniform(-0.2, 1.2, 1000) for _ in range(ndims)]
        out = np.zeros(1000)
        gc.collect()
        r0 = rss_mb()
        interp = it.MulticubicRegular.new(
            [4] * ndims, np.zeros(ndims), np.full(ndims, 1 / 3), vals.ravel()
        )
        interp.eval(obs, out)
        rows["interpn-tpu"].append(rss_mb() - r0)
        del interp
        from scipy.interpolate import RegularGridInterpolator

        gc.collect()
        r0 = rss_mb()
        rgi = RegularGridInterpolator(
            tuple(axes), vals, method="cubic", bounds_error=False, fill_value=None
        )
        rgi(np.stack(obs, -1))
        rows["scipy RGI"].append(rss_mb() - r0)
        del rgi
        print(f"{ndims}D: interpn-tpu +{rows['interpn-tpu'][-1]:.1f} MB, "
              f"scipy +{rows['scipy RGI'][-1]:.1f} MB", flush=True)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig, ax = plt.subplots(figsize=(6.5, 4), constrained_layout=True)
    fig.patch.set_facecolor("#fcfcfb")
    for name, color in [("interpn-tpu", "#2a78d6"), ("scipy RGI", "#eb6834")]:
        ax.plot(range(1, max_dims + 1), rows[name], "o-", lw=2, ms=4,
                color=color, label=name)
    ax.set_xlabel("dimensions")
    ax.set_ylabel("RSS growth per construct+eval (MB)")
    ax.set_title("Cubic, 4x...x4 grid, 1000 obs")
    ax.grid(alpha=0.25)
    ax.legend(fontsize=8)
    out_path = Path(__file__).resolve().parent.parent / "docs" / "ram_vs_dims.svg"
    fig.savefig(out_path)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
