"""Shared machinery for the persistent interpolator model classes.

Each concrete class mirrors one reference wrapper
(`src/interpn/multilinear_regular.py` etc.): a frozen pydantic model holding
the grid definition, with `.new()`, `.eval()`, `.eval_unchecked()`,
`.check_bounds()` and byte-identical JSON round-trip.

Extensions beyond the reference API:

* `.eval_jax(obs)` — evaluate device-resident observation arrays and return a
  device array without any host round-trip (the hot path for device callers).
* Grid constants (starts/steps/vals or grids/vals) are device-cached lazily on
  first eval, so repeated `.eval()` calls only transfer the query points,
  preserving the reference's "zero work per call beyond the points" contract.
"""

from __future__ import annotations

from functools import reduce
from typing import Any, ClassVar

import jax
import jax.numpy as jnp
import numpy as np
from pydantic import BaseModel, ConfigDict, PrivateAttr

from .. import native
from .serialization import ArrayF32, ArrayF64


def _np_result(result, obs, out):
    """Reference output contract: fill preallocated numpy `out` in place when
    given, else allocate like obs[0] (`multilinear_regular.py:119-123`)."""
    out_inner = out if out is not None else np.zeros_like(obs[0])
    np.copyto(out_inner, np.asarray(result).reshape(out_inner.shape))
    return out_inner


def arrtype_for(vals: np.ndarray):
    return ArrayF64 if vals.dtype == np.float64 else ArrayF32


class InterpolatorBase(BaseModel):
    model_config = ConfigDict(frozen=True, extra="forbid", arbitrary_types_allowed=True)

    # Minimum grid points per axis the method's stencil needs, enforced at
    # eval time with the reference core's exact message (the reference
    # CONSTRUCTS such models fine and errors inside the Rust kernel, e.g.
    # `src/multilinear/regular.rs:243-245`; concrete classes override).
    _MIN_GRID: ClassVar[int] = 2
    _MIN_GRID_MSG: ClassVar[str] = "All grids must have at least two entries"

    # Lazily-built device cache: subclass-specific tuple of device arrays plus
    # any static metadata needed by the jitted kernel.
    _dev: Any = PrivateAttr(default=None)
    # Lazily-prepared native CPU callable (grid constants frozen), or False
    # when the native backend is unavailable for this configuration.
    _native: Any = PrivateAttr(default=None)
    # One-time eval-size guard result (None = not yet checked).
    _grid_ok: Any = PrivateAttr(default=None)

    def __getstate__(self):
        """Models pickle at any time, like the reference's pure-data
        classes: the lazily-built caches (device arrays, the native ctypes
        closure — a local function, unpicklable) are dropped and rebuilt on
        first eval after unpickling."""
        state = super().__getstate__()
        priv = dict(state.get("__pydantic_private__") or {})
        priv["_dev"] = None
        priv["_native"] = None
        priv["_grid_ok"] = None
        state["__pydantic_private__"] = priv
        # object.__setattr__ (used on this frozen model) writes into the
        # instance __dict__, not __pydantic_private__ — scrub there too
        d = dict(state.get("__dict__") or {})
        for k in ("_dev", "_native", "_grid_ok"):
            d.pop(k, None)
        state["__dict__"] = d
        return state

    # ---- subclass hooks -------------------------------------------------
    def _device_constants(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def _eval_device(self, dev, obs_j):  # pragma: no cover - abstract
        raise NotImplementedError

    def ndims(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    # ---- shared API ------------------------------------------------------
    def _dev_cache(self):
        if self._dev is None:
            dev = self._device_constants()
            # First call may happen inside a jit trace (a user wrapping
            # eval_jax); constants created there are trace-local tracers and
            # MUST NOT be cached — they would leak and poison every later
            # call (UnexpectedTracerError). Serve them uncached and let the
            # first eager call populate the cache.
            if any(
                isinstance(x, jax.core.Tracer)
                for x in jax.tree_util.tree_leaves(dev)
            ):
                return dev
            object.__setattr__(self, "_dev", dev)
        return self._dev

    @property
    def _dtype(self):
        return self.vals.data.dtype  # type: ignore[attr-defined]

    def _obs_to_device(self, obs):
        dtype = self._dtype
        cast = jnp.float64 if dtype == np.float64 else jnp.float32
        prepared = []
        for x in obs:
            if isinstance(x, jax.Array):
                prepared.append(x.ravel() if x.dtype == cast else x.astype(cast).ravel())
            else:
                prepared.append(jnp.asarray(np.asarray(x).ravel(), dtype=cast))
        return tuple(prepared)

    def _check_obs_sizes(self, obs, out=None):
        """Reference parity: the core checks that exactly ndims observation
        arrays arrive and that every one (and `out`) has the same length
        (`src/multilinear/regular.rs:257-266` -> "Dimension mismatch").
        Without this, the native per-point loop would read out of bounds on
        a short obs array or silently truncate to a short `out`."""
        if len(obs) != self.ndims():
            raise AssertionError("Dimension mismatch")
        n = None
        for x in obs:
            # np.size, not len: scalar obs entries (historically accepted by
            # this class API) count as 1 instead of raising TypeError
            size = int(x.size) if hasattr(x, "size") else int(np.size(x))
            if n is None:
                n = size
            elif size != n:
                raise AssertionError("Dimension mismatch")
        if out is not None and int(out.size) != n:
            raise AssertionError("Dimension mismatch")

    def _check_grid_sizes(self):
        """Eval-time stencil-size floor (reference parity: the Rust core
        rejects under-sized grids at eval, not at construction).

        Raised explicitly rather than via `assert`: this guard fronts the
        native C++ kernels' stencil gathers (an under-sized grid would read
        out of bounds), so it must survive `python -O`."""
        if self._grid_ok is None:
            object.__setattr__(
                self,
                "_grid_ok",
                all(int(d) >= self._MIN_GRID for d in self._grid_sizes()),
            )
        if not self._grid_ok:
            raise AssertionError(self._MIN_GRID_MSG)

    def _check_eval_dtypes(self, obs, out=None):
        """Reference parity: the wrapper classes hand obs/out straight to
        monomorphized kernels, so an ARRAY of any other dtype — the other
        float width, or an integer array — raises TypeError (PyO3's
        `PyReadonlyArray1<T>` extraction refuses them, `src/python.rs:58-80`)
        instead of silently casting or bit-reinterpreting. Non-array
        inputs (lists, scalars) remain accepted and are converted — a
        documented extension of the class API."""
        want = np.dtype(self._dtype)
        pairs = [("obs", o) for o in obs]
        if out is not None:
            pairs.append(("out", out))
        for name, a in pairs:
            dt = getattr(a, "dtype", None)
            if dt is None:
                continue
            dt = np.dtype(dt)
            if dt != want:
                raise TypeError(
                    f"argument '{name}': expected a {want.name} array,"
                    f" got {dt.name}"
                )

    def _eval_device_full(self, dev, obs_j):
        """(result, unrepresentable_flag_or_None). Regular-grid kernels
        return the flag (see raw._unrep_flag); rectilinear never error
        (reference parity: bisection instead of an isize cast).

        eval_jax discards the flag but still pays for it: one extra
        elementwise+reduce pass over obs, kept rather than compiling a
        second executable per shape."""
        res = self._eval_device(dev, obs_j)
        return res if isinstance(res, tuple) else (res, None)

    def eval_jax(self, obs) -> jax.Array:
        """Evaluate on device and return a device array (device fast
        path; not part of the reference API). Unlike eval(), this never
        raises on NaN/inf coordinates — blocking on a device flag would
        break async dispatch; invalid coordinates propagate as NaN in the
        usual JAX way."""
        if self._dtype not in (np.float64, np.float32):
            raise TypeError(f"Unexpected data type: {self._dtype}")
        self._check_grid_sizes()
        self._check_obs_sizes(obs)
        return self._eval_device_full(self._dev_cache(), self._obs_to_device(obs))[0]

    def eval(self, obs, out=None):
        """Evaluate at observation points, optionally writing into a
        preallocated array (reference semantics)."""
        if out is not None:
            return self.eval_unchecked(obs, out)
        # allocate in the MODEL dtype: zeros_like(obs[0]) would produce
        # float64 for list observations and trip the strict out-dtype
        # check on float32 models (lists are a documented accepted input)
        out = np.zeros(np.shape(obs[0]), dtype=self._dtype)
        self.eval_unchecked(obs, out)
        return out

    def _prepare_native(self):  # pragma: no cover - abstract
        return None

    def gradient_jax(self, obs):
        """Partial derivatives of the interpolant at each observation point
        (extension; the reference has no derivative API).

        Returns a tuple of ndims device arrays, each shaped like obs[0]:
        d(interpolant)/d(x_k). Computed with one forward-mode JVP per
        dimension against the jit-compiled device kernel, so it works for
        every method/grid kind and under extrapolation (piecewise-polynomial
        derivatives; not defined exactly at cell boundaries)."""
        self._check_grid_sizes()
        self._check_obs_sizes(obs)
        obs_j = self._obs_to_device(obs)
        dev = self._dev_cache()
        grads = []
        for k in range(self.ndims()):
            tangents = tuple(
                jnp.ones_like(x) if j == k else jnp.zeros_like(x)
                for j, x in enumerate(obs_j)
            )
            _, dy = jax.jvp(
                lambda *o: self._eval_device_full(dev, tuple(o))[0],
                obs_j,
                tangents,
            )
            grads.append(dy)
        return tuple(grads)

    def warmup(self, n: int) -> None:
        """Precompile the device path for batch size n (production
        serving: pay the one-time XLA compilation before taking traffic;
        not part of the reference API)."""
        import jax

        dtype = jnp.float64 if self._dtype == np.float64 else jnp.float32
        obs = tuple(jnp.zeros(n, dtype=dtype) for _ in range(self.ndims()))
        jax.block_until_ready(self.eval_jax(obs))

    def eval_unchecked(self, obs, out=None):
        """Evaluate without re-validating input layout (reference
        semantics; validation already happened at model construction).

        Host-resident (numpy) data takes the native CPU path; device arrays
        run the jit-compiled kernel with cached device-resident grid
        constants. The hot prologue below is everything between the user's
        call and the C kernel — it decides the reference's headline
        1-observation latency, so it is exact-type checks and ONE pydantic
        private-attr read only (`_native` is truthy only after
        `_check_grid_sizes` passed in the general path, so the guard is
        implied)."""
        nat = self._native
        if nat is not None and nat is not False and type(out) is np.ndarray:
            host = True
            for x in obs:
                if type(x) is not np.ndarray:
                    host = False
                    break
            if (
                host
                and out.flags.c_contiguous
                and native.use_native(out.size)
                and nat(obs, out)
            ):
                return out
        return self._eval_unchecked_general(obs, out)

    def _eval_unchecked_general(self, obs, out=None):
        """Everything the hot prologue doesn't cover: first call (native
        prep), allocated output, non-ndarray/device observations, and the
        device fallback."""
        self._check_grid_sizes()
        out_inner = (
            out if out is not None
            else np.zeros(np.shape(obs[0]), dtype=self._dtype)
        )
        self._check_obs_sizes(obs, out_inner)
        self._check_eval_dtypes(obs, out_inner)
        nat = self._native
        if nat is None:
            prep = self._prepare_native()
            if prep is not None or not native.load_deferred():
                # memoize (closure, or genuinely unavailable) — but NOT
                # when the backend is disabled-and-unbuilt, so flipping
                # INTERPN_TPU_NATIVE back on retries the build
                object.__setattr__(self, "_native", prep or False)
            nat = prep or False
        if nat is not False and type(out_inner) is np.ndarray:
            host = True
            for x in obs:
                if isinstance(x, jax.Array):
                    host = False
                    break
            if (
                host
                and out_inner.flags.c_contiguous
                and native.use_native(out_inner.size)
                and nat(obs, out_inner)
            ):
                return out_inner
        if self._dtype not in (np.float64, np.float32):
            raise TypeError(f"Unexpected data type: {self._dtype}")
        result, bad = self._eval_device_full(
            self._dev_cache(), self._obs_to_device(obs)
        )
        if bad is not None and bool(bad):
            # reference parity: AssertionError from the core's isize cast
            raise AssertionError("Unrepresentable coordinate value")
        return _np_result(result, obs, out_inner)


def prod_dims(dims) -> int:
    return reduce(lambda acc, x: acc * x, dims)


class RegularGridMixin:
    """Device plumbing + bounds checks shared by the regular-grid models
    (fields: dims, starts, steps, vals)."""

    def _grid_sizes(self):
        return [int(d) for d in self.dims]

    def _device_constants(self):
        dims = tuple(int(d) for d in self.dims)
        starts = jnp.asarray(self.starts.data)
        steps = jnp.asarray(self.steps.data)
        vals = jnp.asarray(self.vals.data)
        # One-time host-side finiteness check: inf/NaN sentinels in the grid
        # keep a forced factorized engine off this table (ops.dispatch).
        finite = bool(np.isfinite(self.vals.data).all())
        return (dims, starts, steps, vals, finite)

    def check_bounds(self, obs, atol):
        """Per-dimension bounds-violation flags
        (`multilinear_regular.py:170-212` semantics)."""
        from .. import raw

        ndims = self.ndims()
        out = np.array([False] * ndims)
        dtype = self.vals.data.dtype
        if dtype == np.float64:
            fn = raw.check_bounds_regular_f64
        elif dtype == np.float32:
            fn = raw.check_bounds_regular_f32
        else:
            raise TypeError(f"Unexpected data type: {dtype}")
        fn(
            self.dims,
            self.starts.data,
            self.steps.data,
            [np.asarray(x).flatten() for x in obs],
            atol,
            out,
        )
        return out


class RectilinearGridMixin:
    """Device plumbing + bounds checks shared by the rectilinear-grid models
    (fields: grids, vals)."""

    def _grid_sizes(self):
        return [x.data.size for x in self.grids]

    def _device_constants(self):
        grids = tuple(jnp.asarray(g.data) for g in self.grids)
        vals = jnp.asarray(self.vals.data)
        # See RegularGridMixin._device_constants.
        finite = bool(np.isfinite(self.vals.data).all())
        return (grids, vals, finite)

    def dims(self) -> list[int]:
        return [x.data.size for x in self.grids]

    def check_bounds(self, obs, atol):
        """Per-dimension bounds-violation flags
        (`multilinear_rectilinear.py:163-200` semantics)."""
        from .. import raw

        ndims = self.ndims()
        out = np.array([False] * ndims)
        dtype = self.vals.data.dtype
        if dtype == np.float64:
            fn = raw.check_bounds_rectilinear_f64
        elif dtype == np.float32:
            fn = raw.check_bounds_rectilinear_f32
        else:
            raise TypeError(f"Unexpected data type: {dtype}")
        fn(
            [x.data for x in self.grids],
            [np.asarray(x).flatten() for x in obs],
            atol,
            out,
        )
        return out
