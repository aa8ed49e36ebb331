"""MultilinearRectilinear: multilinear interpolator on a rectilinear grid.

API, validation messages, and JSON schema match the reference
`src/interpn/multilinear_rectilinear.py:24-201`; evaluation runs
`interpn_tpu.ops.linear_rectilinear` (vectorized searchsorted bisection).
"""

from __future__ import annotations

import numpy as np
from numpy.typing import NDArray
from pydantic import model_validator

from .. import raw
from ._base import InterpolatorBase, RectilinearGridMixin, arrtype_for, prod_dims
from .serialization import Array


class MultilinearRectilinear(RectilinearGridMixin, InterpolatorBase):
    """Multilinear interpolation on a rectilinear grid in up to 8 dimensions.

    Construction expects flat (1D, contiguous) arrays sharing one float
    dtype, np.float64 or np.float32; the validator rejects anything else. Grids must be monotonically increasing.
    """

    _MIN_GRID = 2
    _MIN_GRID_MSG = "All grids must have at least 2 entries"

    grids: list[Array]
    vals: Array

    @classmethod
    def new(cls, grids: list[NDArray], vals: NDArray) -> "MultilinearRectilinear":
        """Build a model from per-axis coordinate arrays and a value table.

        Args:
            grids: per-axis coordinate arrays, each strictly increasing.
            vals: grid-point value table, flattened in C (row-major) order
                  (the layout np.meshgrid(..., indexing="ij") produces)
        """
        arrtype = arrtype_for(np.asarray(vals))
        return cls(
            grids=[arrtype(data=np.asarray(x)) for x in grids],
            vals=arrtype(data=np.asarray(vals).flatten()),
        )

    @model_validator(mode="after")
    def _validate_model(self):
        dims = self.dims()
        ndims = self.ndims()
        assert ndims <= 8 and ndims >= 1, (
            "Number of dimensions must be at least 1 and no more than 8"
        )
        assert self.vals.data.size == prod_dims(dims), (
            "Size of value array does not match grid dims"
        )
        assert all([np.all(np.diff(x.data) > 0.0) for x in self.grids]), (
            "All grids must be monotonically increasing"
        )
        assert all([x.data.dtype == self.vals.data.dtype for x in self.grids]), (
            "All grid inputs must be of the same data type (np.float32 or np.float64)"
        )
        assert (
            all([x.data.data.contiguous for x in self.grids])
            and self.vals.data.data.contiguous
        ), "Grid data must be contiguous"
        return self

    def ndims(self) -> int:
        return len(self.grids)

    def _eval_device(self, dev, obs_j):
        grids, vals, finite = dev
        return raw._linear_rectilinear(grids, vals, obs_j, finite)

    def _prepare_native(self):
        from .. import native

        return native.prepare_linear_rectilinear(
            [g.data for g in self.grids], self.vals.data,
            self.vals.data.dtype.type,
        )
