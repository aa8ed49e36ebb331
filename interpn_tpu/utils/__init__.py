"""Small numeric helpers shared across interpn-tpu.

Device-side equivalents of the reference's `src/utils.rs:8-25` (linspace,
C-order meshgrid) plus stride helpers used by the gather-based kernels.
"""

from __future__ import annotations

import math

import numpy as np


def c_strides(dims: tuple[int, ...]) -> tuple[int, ...]:
    """C-order strides (in elements) for a grid with shape `dims`.

    stride[k] = prod(dims[k+1:]). Mirrors the `dimprod` cumulative product in
    the reference (`src/multilinear/regular.rs:316-328`), computed statically
    at trace time so XLA sees constants.
    """
    ndims = len(dims)
    strides = [1] * ndims
    acc = 1
    for k in range(ndims - 1, -1, -1):
        strides[k] = acc
        acc *= dims[k]
    return tuple(strides)


def nvals(dims: tuple[int, ...]) -> int:
    """Total number of grid points."""
    return math.prod(dims)


def corner_offsets(dims: tuple[int, ...], footprint: int) -> np.ndarray:
    """Flat C-order index offsets of the full corner stencil.

    For a footprint of 2 (linear) the stencil is the 2^N hypercube corners; for
    4 (cubic) the 4^N stencil. Offset j of vertex i along dim k is the k-th
    base-`footprint` digit of i, matching the bit/digit-pattern indexing of the
    reference (`src/multilinear/regular.rs:356-367`,
    `src/multicubic/regular.rs:378-388`): dim 0 occupies the lowest digit.

    Returns an int32 array of shape (footprint**ndims,) holding
    sum_k digit_k(i) * stride_k.
    """
    ndims = len(dims)
    strides = c_strides(dims)
    n_verts = footprint**ndims
    verts = np.arange(n_verts, dtype=np.int64)
    out = np.zeros(n_verts, dtype=np.int64)
    for k in range(ndims):
        # true base-`footprint` digit k (reduces to the reference's bit/
        # bit-pair shifts for footprints 2 and 4, and stays correct for
        # non-power-of-two stencils like the quintic spline's 6)
        digit = (verts // footprint**k) % footprint
        out += digit * strides[k]
    return out.astype(np.int32)


def linspace(start: float, stop: float, n: int, dtype=np.float64) -> np.ndarray:
    """Evenly spaced samples, inclusive of both endpoints."""
    return np.linspace(start, stop, n, dtype=dtype)


def meshgrid(axes: list[np.ndarray]) -> np.ndarray:
    """C-order (indexing='ij') tensor-product coordinates.

    Returns an array of shape (prod(len(a) for a in axes), ndims) listing every
    grid point's coordinates in C order — the layout assumed by all `vals`
    arrays. Equivalent to the reference's `utils::meshgrid` (`src/utils.rs`).
    """
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.ravel() for m in mesh], axis=-1)
