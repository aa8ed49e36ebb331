"""Pytree interpolators: interpolation state that crosses JAX transform
boundaries.

The pydantic model classes (reference parity,
``/root/reference/src/interpn/multilinear_regular.py:24-212``) hold numpy
state and cannot be passed through ``jit`` / ``vmap`` / ``scan``.
:class:`JaxInterpolator` is the transform-friendly complement: a registered pytree
whose *arrays are leaves* (grid coordinates and the value table) and whose
configuration (method, grid kind, dims, extrapolation mode) is static
structure. That buys, with no new kernel code:

* **jit arguments** — ``jax.jit(lambda itp, obs: itp(obs))`` compiles once
  per shape/config and accepts new tables without retracing: swapping the
  value table is an argument change, not a new constant baked into the
  executable (``eval_jax`` on the model classes bakes the table).
* **vmap over tables** — map over a batch of value tables sharing one grid
  by marking only the ``vals`` leaf as batched (see
  ``tests/test_functional.py``); the grid stays unbatched.
* **scan / checkpoint / shard_map** — interpolators ride in carries and
  closures like any other pytree.
* **autodiff** — gradients flow into the value table and the observation
  points through the gather tree, which differentiates natively.

Evaluation goes through :mod:`interpn_tpu.ops.dispatch`, so engine
selection (gather tree / factorized) is identical to the model classes'
device path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .ops import dispatch as _dispatch
from .ops import pchip as _pchip

__all__ = ["JaxInterpolator"]

_METHODS = ("linear", "cubic", "nearest", "pchip", "cubic_spline", "quintic")
_SPLINE_DEGREE = {"cubic_spline": 3, "quintic": 5}


def _spline_leaves(grids_host, vals, k, dtype):
    """(knots tuple, coefficients) pytree leaves for the global B-spline
    methods: the collocation prep runs ONCE at construction (host float64,
    content-cached), and the pytree carries knots + coefficients — linear
    in the data, so vmap/grad/jit-argument swaps apply to the COEFFICIENT
    leaf. Construction therefore needs concrete table values."""
    import numpy as np

    from .ops import bspline as _bspline

    if isinstance(vals, jax.core.Tracer):
        raise TypeError(
            "cubic_spline/quintic construction solves the collocation "
            "system on the host and needs concrete table values; build "
            "the interpolator outside jit (it is a pytree — pass it in)"
        )
    knots, coeffs = _bspline.prep_bspline_cached(
        [np.asarray(g, dtype=np.float64) for g in grids_host],
        np.asarray(vals, dtype=np.float64).reshape(-1),
        k,
    )
    return (
        tuple(jnp.asarray(t, dtype=dtype) for t in knots),
        jnp.asarray(coeffs, dtype=dtype),
    )


@jax.tree_util.register_pytree_node_class
class JaxInterpolator:
    """Immutable pytree over (grid arrays, value table) with static config.

    Build with :meth:`regular`, :meth:`rectilinear`, or :meth:`from_model`;
    call with a sequence of per-dimension observation arrays. NaN/inf
    coordinates propagate as NaN (like ``eval_jax``; device-flag semantics
    belong to the host API).
    """

    def __init__(self, *, method, kind, dims, linearize_extrapolation,
                 grid_arrays, vals):
        # internal; no validation here — unflatten passes tracers through
        self.method = method
        self.kind = kind
        self.dims = dims
        self.linearize_extrapolation = linearize_extrapolation
        self.grid_arrays = tuple(grid_arrays)
        self.vals = vals

    # ---- constructors --------------------------------------------------
    @classmethod
    def regular(cls, dims, starts, steps, vals, *, method="linear",
                linearize_extrapolation=True):
        """Regular grid: `dims` static ints, `starts`/`steps` length-ndims
        arrays, `vals` the C-order table (flat or shaped)."""
        dims = tuple(int(d) for d in dims)
        cls._check(method, len(dims))
        if method in _SPLINE_DEGREE:
            import numpy as np

            dtype = jnp.asarray(vals).dtype
            s = np.asarray(starts, dtype=np.float64)
            h = np.asarray(steps, dtype=np.float64)
            grids_host = [s[i] + h[i] * np.arange(d) for i, d in enumerate(dims)]
            knots, coeffs = _spline_leaves(
                grids_host, vals, _SPLINE_DEGREE[method], dtype
            )
            return cls(
                method=method, kind="regular", dims=dims,
                linearize_extrapolation=bool(linearize_extrapolation),
                grid_arrays=knots, vals=coeffs,
            )
        vals = jnp.asarray(vals).reshape(-1)
        return cls(
            method=method, kind="regular", dims=dims,
            linearize_extrapolation=bool(linearize_extrapolation),
            grid_arrays=(jnp.asarray(starts), jnp.asarray(steps)), vals=vals,
        )

    @classmethod
    def rectilinear(cls, grids, vals, *, method="linear",
                    linearize_extrapolation=True):
        """Rectilinear grid: one strictly-increasing 1-D array per axis."""
        grids = tuple(jnp.asarray(g) for g in grids)
        cls._check(method, len(grids))
        if method in _SPLINE_DEGREE:
            knots, coeffs = _spline_leaves(
                grids, vals, _SPLINE_DEGREE[method], grids[0].dtype
            )
            return cls(
                method=method, kind="rectilinear", dims=None,
                linearize_extrapolation=bool(linearize_extrapolation),
                grid_arrays=knots, vals=coeffs,
            )
        vals = jnp.asarray(vals).reshape(-1)
        return cls(
            method=method, kind="rectilinear", dims=None,
            linearize_extrapolation=bool(linearize_extrapolation),
            grid_arrays=grids, vals=vals,
        )

    @classmethod
    def from_model(cls, model):
        """Lift a pydantic model class instance (already validated) into a
        pytree; the model's arrays become leaves."""
        from .models import _base

        base_name = (
            type(model).__name__.replace("Regular", "").replace("Rectilinear", "")
        )
        if base_name == "TensorSpline":
            method = model.method  # "pchip" | "cubic_spline" | "quintic"
        else:
            method = {
                "Multilinear": "linear", "Multicubic": "cubic",
                "Nearest": "nearest",
            }[base_name]
        lin = bool(getattr(model, "linearize_extrapolation", True))
        if isinstance(model, _base.RegularGridMixin):
            return cls.regular(
                model.dims, model.starts.data, model.steps.data,
                model.vals.data, method=method, linearize_extrapolation=lin,
            )
        return cls.rectilinear(
            [g.data for g in model.grids], model.vals.data,
            method=method, linearize_extrapolation=lin,
        )

    @staticmethod
    def _check(method, ndims):
        if method not in _METHODS:
            raise ValueError(f"Method '{method}' is not defined")
        limit = 6 if method == "nearest" else 8
        if not 1 <= ndims <= limit:
            # raise (not `assert`) so the contract survives python -O,
            # matching raw._require
            raise AssertionError("Dimension mismatch")

    # ---- pytree protocol -------------------------------------------------
    def tree_flatten(self):
        children = (*self.grid_arrays, self.vals)
        aux = (self.method, self.kind, self.dims, self.linearize_extrapolation)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        method, kind, dims, lin = aux
        return cls(
            method=method, kind=kind, dims=dims, linearize_extrapolation=lin,
            grid_arrays=children[:-1], vals=children[-1],
        )

    # ---- evaluation --------------------------------------------------
    @property
    def ndims(self):
        return len(self.dims) if self.kind == "regular" else len(self.grid_arrays)

    def __call__(self, obs, *, vals_finite=None):
        """Evaluate at `obs` (a sequence of ndims equally-shaped arrays);
        returns an array of that shape. `vals_finite` overrides the
        traced-table finiteness assumption (docs/api.md, "Non-finite grid
        values")."""
        obs = [jnp.asarray(o) for o in obs]
        if len(obs) != self.ndims or any(o.shape != obs[0].shape for o in obs):
            raise AssertionError("Dimension mismatch")
        shape = obs[0].shape
        flat = [o.reshape(-1) for o in obs]
        if self.method in _SPLINE_DEGREE:
            # both grid kinds store (knots, coefficients) leaves; the
            # evaluation is the batched Cox-de Boor stencil contraction
            from .ops import bspline as _bspline

            out = _bspline.bspline_eval(
                self.grid_arrays, self.vals, flat, _SPLINE_DEGREE[self.method]
            )
            return out.reshape(shape)
        if self.kind == "regular":
            starts, steps = self.grid_arrays
            if self.method == "linear":
                out = _dispatch.linear_regular(
                    self.dims, starts, steps, self.vals, flat,
                    vals_finite=vals_finite,
                )
            elif self.method == "cubic":
                out = _dispatch.cubic_regular(
                    self.dims, starts, steps, self.vals, flat,
                    self.linearize_extrapolation, vals_finite=vals_finite,
                )
            elif self.method == "pchip":
                # nonlinear in the data: always the gather tree, no
                # dispatch alternatives exist (ops/pchip.py)
                out = _pchip.pchip_regular(
                    self.dims, starts, steps, self.vals, flat
                )
            else:
                out = _dispatch.nearest_regular(
                    self.dims, starts, steps, self.vals, flat,
                    vals_finite=vals_finite,
                )
        else:
            grids = self.grid_arrays
            if self.method == "linear":
                out = _dispatch.linear_rectilinear(
                    grids, self.vals, flat, vals_finite=vals_finite
                )
            elif self.method == "cubic":
                out = _dispatch.cubic_rectilinear(
                    grids, self.vals, flat, self.linearize_extrapolation,
                    vals_finite=vals_finite,
                )
            elif self.method == "pchip":
                out = _pchip.pchip_rectilinear(grids, self.vals, flat)
            else:
                out = _dispatch.nearest_rectilinear(
                    grids, self.vals, flat, vals_finite=vals_finite
                )
        return out.reshape(shape)

    def batch_axes(self, *, vals=0, grids=None):
        """An `in_axes`/`out_axes` pytree for `jax.vmap`: same structure as
        self with axis specs in the leaf slots. Default maps over a batch
        of value tables sharing one (unbatched) grid."""
        n = len(self.grid_arrays)
        return self.tree_unflatten(
            (self.method, self.kind, self.dims, self.linearize_extrapolation),
            (*([grids] * n), vals),
        )

    def __repr__(self):
        grid = (
            f"dims={self.dims}" if self.kind == "regular"
            else f"ndims={self.ndims}"
        )
        return (
            f"JaxInterpolator({self.method}, {self.kind}, {grid}, "
            f"vals={getattr(self.vals, 'shape', None)})"
        )
