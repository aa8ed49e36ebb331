"""1D fast-path interpolators.

Batched equivalent of the reference's `one_dim` module
(`src/one_dim/mod.rs:28-187`, `linear.rs:9-86`, `hold.rs:8-108`): lightweight
grids (regular / rectilinear) plus interpolants Linear1D, LinearHoldLast1D,
Left1D, Right1D, Nearest1D. All evaluation is batched and branchless; the
extrapolation flag of the reference becomes two boolean masks.

These are plain functional kernels wrapped in tiny classes so the call shape
mirrors the reference (`Linear1D::new(grid).eval(locs, out)`), but everything
is jit-able: `Linear1D(RegularGrid1D(start, step, vals)).eval(locs)`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import jax.numpy as jnp
import numpy as np

from ._gather import take1, take_small
from . import locate as _locate

_I32 = jnp.int32


def _length(x) -> int:
    """Static leading-axis length of an array-like (works for tracers)."""
    shape = getattr(x, "shape", None)
    if shape is not None:
        if len(shape) == 0:
            return 1
        return int(shape[0])
    return len(x)


@dataclass(frozen=True)
class GridSample1D:
    """Bracketing sample like the reference's `GridSample`
    (`src/one_dim/mod.rs:19-25`), with extrapolation masks instead of an
    enum."""

    x0: Any
    y0: Any
    x1: Any
    y1: Any
    outside_low: Any
    outside_high: Any


@dataclass(frozen=True)
class RegularGrid1D:
    """Uniformly spaced grid (`src/one_dim/mod.rs:78-138`)."""

    start: Any
    step: Any
    vals: Any

    def __post_init__(self):
        # The reference's RegularGrid1D::new accepts a 1-point grid but its
        # index() then underflows `vals.len() - 2` (debug panic); refusing
        # up front is the batched-safe version of that contract.
        if _length(self.vals) < 2:
            raise ValueError("Length mismatch")

    def at(self, loc) -> GridSample1D:
        vals = jnp.asarray(self.vals)
        n = vals.shape[0]
        start = jnp.asarray(self.start, dtype=vals.dtype)
        step = jnp.asarray(self.step, dtype=vals.dtype)
        stop = start + step * (n - 1)
        outside_low = loc < start
        outside_high = loc > stop
        # The REGULAR reference grid ERRORS on any location whose cell
        # index is unrepresentable as isize — non-finite OR huge finite
        # (`<isize as NumCast>::from(fi)` fails, "Unrepresentable number",
        # src/one_dim/mod.rs:99-115). A batched kernel cannot raise per
        # point, so the documented deviation is NaN out for exactly that
        # set (the sanitized index keeps the gather in bounds —
        # floor(NaN)/overflow casts are implementation-defined). The N-d
        # regular path raises batch-wide instead (raw._unrep_flag); the
        # 1D family stays jit-able so it marks per point.
        fi_raw = jnp.floor((loc - start) / step)
        bad = ~jnp.isfinite(loc) | (jnp.abs(fi_raw) >= 2.0**63)
        fi = jnp.floor((jnp.where(bad, start, loc) - start) / step)
        i = jnp.clip(fi, 0.0, float(n - 2)).astype(_I32)
        x0 = start + step * i.astype(vals.dtype)
        x1 = x0 + step
        y0 = jnp.where(bad, jnp.nan, take_small(vals, i))
        y1 = jnp.where(bad, jnp.nan, take_small(vals, i + 1))
        return GridSample1D(x0, y0, x1, y1, outside_low, outside_high)


@dataclass(frozen=True)
class RectilinearGrid1D:
    """Monotonic non-uniform grid (`src/one_dim/mod.rs:142-187`)."""

    grid: Any
    vals: Any

    def __post_init__(self):
        # Reference contract: `grid.len() != vals.len() || grid.len() < 2`
        # is "Length mismatch" at construction (src/one_dim/mod.rs:148-154).
        ng = _length(self.grid)
        if ng != _length(self.vals) or ng < 2:
            raise ValueError("Length mismatch")

    def at(self, loc) -> GridSample1D:
        grid = jnp.asarray(self.grid)
        vals = jnp.asarray(self.vals)
        n = grid.shape[0]
        sp = _locate.searchsorted(grid, loc, side="left").astype(_I32)
        # partition_point(< NaN) = 0 (reference + native bisection);
        # jnp.searchsorted sorts NaN last — see ops/locate.py. Unlike the
        # REGULAR 1D grid, the rectilinear reference never errors on
        # non-finite locations (its index() is pure bisection with no
        # float->int cast, src/one_dim/mod.rs:152-166): NaN locates at the
        # LOW edge cell with Extrap::Inside (every comparison false), inf
        # at the edges — the bracketing values flow through each
        # interpolant's own arithmetic (Nearest1D(NaN) -> vals[1],
        # Linear1D(NaN) -> NaN, Left1D(inf) -> last value, ...).
        sp = jnp.where(jnp.isnan(loc), 0, sp)
        i = jnp.clip(sp - 1, 0, n - 2)
        outside_low = loc < grid[0]
        outside_high = loc > grid[-1]
        x0 = take_small(grid, i)
        x1 = take_small(grid, i + 1)
        y0 = take_small(vals, i)
        y1 = take_small(vals, i + 1)
        return GridSample1D(x0, y0, x1, y1, outside_low, outside_high)


class _Interp1D:
    """Base: batched eval over locations (`src/one_dim/mod.rs:41-74`).

    `eval(locs)` allocates (the reference's `eval_alloc`); `eval(locs, out)`
    writes into a caller-provided host buffer and raises the reference's
    "Length mismatch" on a size disagreement (`src/one_dim/mod.rs:51-55`).
    """

    def __init__(self, grid):
        self.grid = grid

    def _eval(self, locs):
        raise NotImplementedError  # subclass evaluation hook

    def eval(self, locs, out=None):
        result = self._eval(locs)
        if out is None:
            return result
        if _length(out) != _length(locs):
            raise ValueError("Length mismatch")
        np.copyto(out, np.asarray(result))
        return out

    # Alias matching the reference's allocating variant.
    def eval_alloc(self, locs):
        return self.eval(locs)


class Linear1D(_Interp1D):
    """Linear interpolation/extrapolation (`src/one_dim/linear.rs:9-38`)."""

    def _eval(self, locs):
        s = self.grid.at(locs)
        slope = (s.y1 - s.y0) / (s.x1 - s.x0)
        return s.y0 + slope * (locs - s.x0)


class LinearHoldLast1D(_Interp1D):
    """Linear inside; holds edge values outside
    (`src/one_dim/linear.rs:43-86`)."""

    def _eval(self, locs):
        s = self.grid.at(locs)
        slope = (s.y1 - s.y0) / (s.x1 - s.x0)
        inside = s.y0 + slope * (locs - s.x0)
        return jnp.where(s.outside_low, s.y0, jnp.where(s.outside_high, s.y1, inside))


class Left1D(_Interp1D):
    """Hold-last piecewise constant (`src/one_dim/hold.rs:8-40`)."""

    def _eval(self, locs):
        s = self.grid.at(locs)
        return jnp.where(s.outside_high, s.y1, s.y0)


class Right1D(_Interp1D):
    """Hold-next piecewise constant (`src/one_dim/hold.rs:43-75`)."""

    def _eval(self, locs):
        s = self.grid.at(locs)
        return jnp.where(s.outside_low, s.y0, s.y1)


class Nearest1D(_Interp1D):
    """Nearest value; ties take the left value (`src/one_dim/hold.rs:79-108`)."""

    def _eval(self, locs):
        s = self.grid.at(locs)
        dx0 = jnp.abs(locs - s.x0)
        dx1 = jnp.abs(locs - s.x1)
        return jnp.where(dx1 >= dx0, s.y0, s.y1)
