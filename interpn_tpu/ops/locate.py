"""Grid-cell location, vectorized over query batches.

Regular grids use the closed-form locate of the reference
(`src/multilinear/regular.rs:413-425`, `src/multicubic/regular.rs:431-469`):
``iloc = floor((x - start)/step)``, clamped to the interior so that
out-of-bounds points land in the edge cell and extrapolate implicitly via
|t| > 1 — fully branchless.

Rectilinear grids use a vectorized bisection: ``jnp.searchsorted(grid, x,
side='left')`` returns exactly ``grid.partition_point(|g| g < x)``
(`src/multilinear/rectilinear.rs:352-370`, `src/multicubic/rectilinear.rs:377`).

All index math is int32 (grids are far below 2^31 points); float locations are
clamped *before* the int cast so that extreme out-of-range queries cannot
overflow. Saturation regions for the cubic method are returned as boolean
masks rather than an enum, so downstream evaluation is pure `where`-selects.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ._gather import take1, take_small

_I32 = jnp.int32

# Above 64 entries the bisection uses method='compare_all' (a branch-free
# broadcast compare-count, the same partition_point shape the reference's
# bisection computes) instead of the default 'scan'. The threshold was set
# on a TPU, whose 'scan' lowering collapsed past 64 entries; it is not
# measured on the GPU, and compare_all costs O(len) per query. All
# device-side bisections go through this helper.
_SS_SCAN_MAX = 64


def searchsorted(grid, x, side: str = "left"):
    """`jnp.searchsorted` with a length-based method choice: the default
    scan lowering up to 64 entries, the vectorized compare-count above."""
    method = "scan" if int(grid.shape[0]) <= _SS_SCAN_MAX else "compare_all"
    return jnp.searchsorted(grid, x, side=side, method=method)


class CubicLoc(NamedTuple):
    """Per-dimension cubic cell location and saturation masks."""

    loc: jnp.ndarray  # int32 lower corner of the 4-point stencil
    t: jnp.ndarray  # normalized coordinate w.r.t. stencil index 1
    low: jnp.ndarray  # bool: InsideLow | OutsideLow
    high: jnp.ndarray  # bool: InsideHigh | OutsideHigh
    outside: jnp.ndarray  # bool: OutsideLow | OutsideHigh


def locate_regular_linear(x, start, step, dim: int):
    """Lower corner + normalized coordinate for a 2-point stencil.

    Matches `MultilinearRegular::get_loc` + the `dts` computation
    (`src/multilinear/regular.rs:329-339,413-425`): clamp floor((x-start)/step)
    to [0, dim-2]; t measured from the clamped cell origin so extrapolation is
    expressed by t outside [0, 1].
    """
    dtype = x.dtype
    floc = jnp.floor((x - start) / step)
    dimmax = max(dim - 2, 0)
    loc = jnp.clip(floc, 0.0, float(dimmax)).astype(_I32)
    t = (x - (start + step * loc.astype(dtype))) / step
    return loc, t


def locate_regular_cubic(x, start, step, dim: int) -> CubicLoc:
    """Lower corner of the 4-point stencil plus saturation masks.

    Matches `MulticubicRegular::get_loc` (`src/multicubic/regular.rs:431-469`):
    iloc = floor((x-start)/step) - 1, clamped to [0, dim-4]; t is measured from
    stencil index 1. Saturation cases (evaluated with the same precedence as
    the reference's if-chain):
      OutsideLow:  iloc < -1     InsideLow:  iloc == -1
      OutsideHigh: iloc > dim-3  InsideHigh: iloc == dim-3
    """
    dtype = x.dtype
    floc = jnp.floor((x - start) / step)
    iloc = floc - 1.0  # float to avoid int overflow before clamping
    dimmax = max(dim - 4, 0)
    loc = jnp.clip(iloc, 0.0, float(dimmax)).astype(_I32)
    low = iloc <= -1.0
    high = (~low) & (iloc >= float(dim - 3))
    outside = (iloc < -1.0) | ((~low) & (iloc > float(dim - 3)))
    t = (x - (start + step * (loc + 1).astype(dtype))) / step
    return CubicLoc(loc, t, low, high, outside)


def locate_rectilinear_linear(x, grid):
    """Lower corner for a 2-point stencil on a monotonic grid.

    Matches `MultilinearRectilinear::get_loc`
    (`src/multilinear/rectilinear.rs:352-370`): partition_point(< x) - 1,
    clamped to [0, len-2]. Returns (loc, x0, x1) where x0/x1 bracket the
    (possibly clamped) cell.
    """
    dim = grid.shape[0]
    sp = searchsorted(grid, x, side="left").astype(_I32)
    # partition_point(< NaN) counts zero elements (every comparison is
    # false); jnp.searchsorted instead sorts NaN after the grid (returns
    # n), which would select the OPPOSITE edge cell vs the reference and
    # the native bisection. Pin the reference semantics.
    sp = jnp.where(jnp.isnan(x), 0, sp)
    iloc = sp - 1
    loc = jnp.clip(iloc, 0, max(dim - 2, 0))
    x0 = take_small(grid, loc)
    x1 = take_small(grid, loc + 1)
    return loc, x0, x1


def locate_rectilinear_cubic(x, grid) -> tuple[CubicLoc, jnp.ndarray]:
    """Lower corner of the 4-point stencil on a monotonic grid + cell coords.

    Matches `MulticubicRectilinear::get_loc`
    (`src/multicubic/rectilinear.rs:366-408`): iloc = partition_point(< x) - 2,
    clamped to [0, len-4]. Saturation:
      OutsideLow:  iloc == -2    InsideLow:  iloc == -1
      OutsideHigh: iloc == n-2   InsideHigh: iloc == n-3

    Returns (CubicLoc, grid_cell) where grid_cell is a tuple of 4 arrays
    shaped like x holding grid[loc+0..3] (four flat gathers — see
    `ops/_gather.py` for why). CubicLoc.t is *not* populated for rectilinear
    grids (the normalized coordinate is case-dependent and computed in the
    evaluation kernel from x and grid_cell); it carries x instead.
    """
    dim = grid.shape[0]
    sp = searchsorted(grid, x, side="left").astype(_I32)
    sp = jnp.where(jnp.isnan(x), 0, sp)  # see locate_rectilinear_linear
    iloc = sp - 2
    loc = jnp.clip(iloc, 0, max(dim - 4, 0))
    low = iloc <= -1
    high = (~low) & (iloc >= dim - 3)
    outside = (iloc < -1) | ((~low) & (iloc > dim - 3))
    grid_cell = tuple(take_small(grid, loc + i) for i in range(4))
    return CubicLoc(loc, x, low, high, outside), grid_cell
