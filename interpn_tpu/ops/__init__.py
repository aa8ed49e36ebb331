"""Batched interpolation kernels (pure JAX / XLA).

The exported names dispatch between two implementations per family (gather
tree vs factorized contraction, see `ops/dispatch.py`); the underlying
implementations remain importable from their submodules (`ops.linear`,
`ops.cubic`, `ops.nearest`, `ops.factorized`). `raw` wraps these with the
reference-compatible flat API and `interpn_tpu.models` with the persistent
pydantic classes.
"""

from .bounds import check_bounds_rectilinear, check_bounds_regular
from .bspline import bspline_eval, prep_bspline
from .dispatch import (
    cubic_rectilinear,
    cubic_regular,
    linear_rectilinear,
    linear_regular,
    nearest_rectilinear,
    nearest_regular,
)
from .pchip import pchip_rectilinear, pchip_regular
from .stack import (
    cubic_rectilinear_stack,
    cubic_regular_stack,
    linear_rectilinear_stack,
    linear_regular_stack,
    nearest_rectilinear_stack,
    nearest_regular_stack,
)

__all__ = [
    "check_bounds_rectilinear",
    "check_bounds_regular",
    "cubic_rectilinear",
    "cubic_regular",
    "linear_rectilinear",
    "linear_regular",
    "nearest_rectilinear",
    "nearest_regular",
    "bspline_eval",
    "pchip_rectilinear",
    "pchip_regular",
    "prep_bspline",
    "cubic_rectilinear_stack",
    "cubic_regular_stack",
    "linear_rectilinear_stack",
    "linear_regular_stack",
    "nearest_rectilinear_stack",
    "nearest_regular_stack",
]
