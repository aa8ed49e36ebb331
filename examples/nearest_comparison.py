"""Quality-of-fit figure for nearest-neighbor interpolation.

JAX analogue of the reference's `examples/nearest_comparison.py`:
compares NearestRectilinear against scipy's griddata(method="nearest") on a
slightly irregular 2D rectilinear grid and writes an SVG into docs/.

Run: python examples/nearest_comparison.py
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np
from scipy.interpolate import griddata

from interpn_tpu import NearestRectilinear

DOCS = Path(__file__).resolve().parent.parent / "docs"


def truth(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    return np.sin(x) + 0.5 * np.cos(2.0 * y) + 0.15 * x * y


def irregular_axis(rng: np.random.Generator, size: int, lo: float, hi: float):
    base = np.linspace(lo, hi, size)
    base[1:-1] += (rng.random(size - 2) - 0.5) * 0.5 * (hi - lo) / size
    assert np.all(np.diff(base) > 0)
    return base


def main() -> None:
    rng = np.random.default_rng(7)
    gx = irregular_axis(rng, 14, -3.0, 3.0)
    gy = irregular_axis(rng, 11, -2.0, 2.0)
    xg, yg = np.meshgrid(gx, gy, indexing="ij")
    vals = truth(xg, yg)

    interp = NearestRectilinear.new([gx, gy], vals)

    nx = ny = 160
    qx = np.linspace(-3.6, 3.6, nx)
    qy = np.linspace(-2.5, 2.5, ny)
    qxg, qyg = np.meshgrid(qx, qy, indexing="ij")
    ours = interp.eval([qxg.ravel(), qyg.ravel()]).reshape(nx, ny)

    sci = griddata(
        (xg.ravel(), yg.ravel()),
        vals.ravel(),
        (qxg, qyg),
        method="nearest",
    )

    fig, axes = plt.subplots(1, 3, figsize=(13, 4), constrained_layout=True)
    for ax, data, title in [
        (axes[0], truth(qxg, qyg), "truth"),
        (axes[1], ours, "interpn-tpu NearestRectilinear"),
        (axes[2], sci, "scipy griddata nearest"),
    ]:
        im = ax.pcolormesh(qxg, qyg, data, shading="auto")
        ax.plot(xg.ravel(), yg.ravel(), "k.", ms=1.5)
        ax.set_title(title, fontsize=10)
        fig.colorbar(im, ax=ax, shrink=0.85)
    out = DOCS / "nearest_quality_of_fit.svg"
    out.parent.mkdir(exist_ok=True)
    fig.savefig(out)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
