"""Quality-of-fit comparison: multicubic vs scipy cubic interpolation.

JAX analogue of the reference's `examples/cubic_comparison.py`:
evaluates MulticubicRegular / MulticubicRectilinear on quadratic, sine, and
step functions across interpolation and extrapolation regions, against
scipy's RegularGridInterpolator (cubic), and writes an SVG comparison figure
into docs/ (matplotlib — plotly is not available in this image).

Run: python examples/cubic_comparison.py
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np
from scipy.interpolate import RegularGridInterpolator

from interpn_tpu import MulticubicRectilinear, MulticubicRegular

DOCS = Path(__file__).resolve().parent.parent / "docs"


def step_fn(x: np.ndarray) -> np.ndarray:
    return np.where(x < 0.0, 0.0, 1.0)


FN_DEFS = [
    ("Quadratic", lambda x: x**2),
    ("Sine", np.sin),
    ("Step", step_fn),
]


def main() -> None:
    rng = np.random.default_rng(42)
    ngrid = 9
    xmin, xmax = -3.0, 3.0
    xobs = np.linspace(xmin - 2.0, xmax + 2.0, 400)

    fig, axes = plt.subplots(
        len(FN_DEFS), 2, figsize=(11, 9), sharex=True, constrained_layout=True
    )
    for row, (name, fn) in enumerate(FN_DEFS):
        # Regular grid
        xg = np.linspace(xmin, xmax, ngrid)
        yg = fn(xg)
        interp_reg = MulticubicRegular.new(
            [ngrid],
            np.array([xg[0]]),
            np.array([xg[1] - xg[0]]),
            yg,
            linearize_extrapolation=True,
        )
        y_reg = interp_reg.eval([xobs])

        # Rectilinear grid: perturbed but monotonic
        xr = xg + (rng.random(ngrid) - 0.5) * 0.25
        yr = fn(xr)
        interp_rect = MulticubicRectilinear.new([xr], yr)
        y_rect = interp_rect.eval([xobs])

        sci = RegularGridInterpolator(
            (xg,), yg, method="cubic", bounds_error=False, fill_value=None
        )
        y_sci = sci(xobs[:, None])

        for col, (grid_name, xs, ys, yhat) in enumerate(
            [("Regular", xg, yg, y_reg), ("Rectilinear", xr, yr, y_rect)]
        ):
            ax = axes[row][col]
            ax.axvspan(xs[0], xs[-1], color="0.92", label="_grid span")
            ax.plot(xobs, fn(xobs), "k--", lw=1, label="truth")
            ax.plot(xobs, yhat, lw=1.5, label="interpn-tpu cubic")
            if col == 0:
                ax.plot(xobs, y_sci, lw=1, alpha=0.7, label="scipy cubic")
            ax.plot(xs, ys, "o", ms=3, color="k", label="grid points")
            ax.set_title(f"{name} — {grid_name} grid")
            if row == 0 and col == 0:
                ax.legend(fontsize=8)
    out = DOCS / "cubic_quality_of_fit.svg"
    out.parent.mkdir(exist_ok=True)
    fig.savefig(out)
    print(f"wrote {out}")
    plt.close(fig)

    # The reference's published per-grid-kind artifact family
    # (docs/{1d,2d}_quality_of_fit_{Regular,Rectilinear}.*).
    for kind in ("Regular", "Rectilinear"):
        _fig_1d(kind, rng)
        _fig_2d(kind, rng)


# dataviz reference palette: method = hue (slot 1/2), truth in ink
_C_OURS = "#2a78d6"
_C_SCIPY = "#eb6834"


def _make_1d_interp(kind, xg, yg):
    if kind == "Regular":
        return MulticubicRegular.new(
            [len(xg)], np.array([xg[0]]), np.array([xg[1] - xg[0]]), yg,
            linearize_extrapolation=True,
        )
    return MulticubicRectilinear.new([xg], yg)


def _fig_1d(kind, rng):
    ngrid = 9
    xmin, xmax = -3.0, 3.0
    xobs = np.linspace(xmin - 2.0, xmax + 2.0, 400)
    fig, axes = plt.subplots(
        2, len(FN_DEFS), figsize=(12, 6), sharex=True, constrained_layout=True
    )
    for col, (name, fn) in enumerate(FN_DEFS):
        xg = np.linspace(xmin, xmax, ngrid)
        if kind == "Rectilinear":
            xg = np.sort(xg + (rng.random(ngrid) - 0.5) * 0.25)
        yg = fn(xg)
        yhat = _make_1d_interp(kind, xg, yg).eval([xobs])
        sci = RegularGridInterpolator(
            (xg,), yg, method="cubic", bounds_error=False, fill_value=None
        )
        y_sci = sci(xobs[:, None])
        truth = fn(xobs)

        ax = axes[0][col]
        ax.axvspan(xg[0], xg[-1], color="0.93")
        ax.plot(xobs, truth, "k--", lw=1, label="truth")
        ax.plot(xobs, yhat, lw=2, color=_C_OURS, label="interpn-tpu cubic")
        ax.plot(xobs, y_sci, lw=2, color=_C_SCIPY, alpha=0.8, label="scipy cubic")
        ax.plot(xg, yg, "o", ms=3, color="k")
        ax.set_title(name)
        if col == 0:
            ax.legend(fontsize=8)

        ax = axes[1][col]
        ax.axvspan(xg[0], xg[-1], color="0.93")
        ax.semilogy(xobs, np.abs(yhat - truth) + 1e-18, lw=2, color=_C_OURS)
        ax.semilogy(xobs, np.abs(y_sci - truth) + 1e-18, lw=2, color=_C_SCIPY,
                    alpha=0.8)
        ax.set_title(f"Error, {name}")
    fig.suptitle(f"1D cubic quality of fit — {kind} grid")
    out = DOCS / f"1d_quality_of_fit_{kind}.svg"
    fig.savefig(out)
    print(f"wrote {out}")
    plt.close(fig)


def _fig_2d(kind, rng):
    ngrid = 11
    xmin, xmax = -3.0, 3.0
    fn = lambda x, y: np.sin(x) * np.cos(0.8 * y) + 0.1 * x  # noqa: E731
    xg = np.linspace(xmin, xmax, ngrid)
    yg_ax = np.linspace(xmin, xmax, ngrid)
    if kind == "Rectilinear":
        xg = np.sort(xg + (rng.random(ngrid) - 0.5) * 0.3)
        yg_ax = np.sort(yg_ax + (rng.random(ngrid) - 0.5) * 0.3)
    gx, gy = np.meshgrid(xg, yg_ax, indexing="ij")
    vals = fn(gx, gy).ravel()
    if kind == "Regular":
        interp = MulticubicRegular.new(
            [ngrid, ngrid],
            np.array([xg[0], yg_ax[0]]),
            np.array([xg[1] - xg[0], yg_ax[1] - yg_ax[0]]),
            vals,
            linearize_extrapolation=True,
        )
    else:
        interp = MulticubicRectilinear.new([xg, yg_ax], vals)
    n = 160
    ox = np.linspace(xmin - 1.0, xmax + 1.0, n)
    oy = np.linspace(xmin - 1.0, xmax + 1.0, n)
    mx, my = np.meshgrid(ox, oy, indexing="ij")
    yhat = interp.eval([mx.ravel(), my.ravel()]).reshape(n, n)
    sci = RegularGridInterpolator(
        (xg, yg_ax), fn(gx, gy), method="cubic",
        bounds_error=False, fill_value=None,
    )
    y_sci = sci(np.stack([mx.ravel(), my.ravel()], -1)).reshape(n, n)
    truth = fn(mx, my)

    err_ours = np.abs(yhat - truth)
    err_sci = np.abs(y_sci - truth)
    vmax = max(err_ours.max(), err_sci.max())
    fig, axes = plt.subplots(1, 2, figsize=(11, 4.6), constrained_layout=True)
    for ax, err, title in [
        (axes[0], err_ours, "interpn-tpu cubic |error|"),
        (axes[1], err_sci, "scipy cubic |error|"),
    ]:
        im = ax.imshow(
            err.T, origin="lower", cmap="Blues",  # sequential, single hue
            extent=[ox[0], ox[-1], oy[0], oy[-1]], vmin=0.0, vmax=vmax,
        )
        ax.add_patch(plt.Rectangle(
            (xg[0], yg_ax[0]), xg[-1] - xg[0], yg_ax[-1] - yg_ax[0],
            fill=False, ls="--", lw=1, ec="#52514e",
        ))
        ax.set_title(title)
    fig.colorbar(im, ax=axes, shrink=0.85, label="|error| (grid box dashed)")
    fig.suptitle(f"2D cubic quality of fit — {kind} grid")
    out = DOCS / f"2d_quality_of_fit_{kind}.svg"
    fig.savefig(out)
    print(f"wrote {out}")
    plt.close(fig)


if __name__ == "__main__":
    main()
