"""ctypes bindings + build machinery for the native CPU kernels.

The shared library is built on first use with g++ (the extern-C + ctypes
route keeps the binding layer dependency-free). The build is cached next to
the source, keyed on the source hash and on the host's CPU feature tag
(`config.host_feature_tag`): it is compiled with -march=native, so a build
copied from another host is rebuilt, never loaded.

Dispatch policy: by default ALL host-resident (numpy) batches route here,
and device-resident callers use the JAX API directly. The crossover against
the host->device->host round trip to a GPU is not measured.
INTERPN_TPU_NATIVE=0 disables the native path entirely;
INTERPN_TPU_NATIVE_THRESHOLD=<n> restores a size crossover to the device
path.

Call-overhead design: all pointer arguments are passed as raw integers
(`ndarray.ctypes.data`) into `c_void_p` slots — bypassing the expensive
`data_as`/`cast` machinery — and the persistent model classes cache a
`prepare_*` closure that freezes the grid-constant arguments once, so a warm
`.eval()` on a small batch costs only the obs-pointer packing plus the C call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "interpn_native.cpp"

# Optional crossover: if set, batches >= this size go to the device path.
# Unset (default), ALL host-resident (numpy) batches use the native path
# (the crossover is not measured against a GPU round trip), and
# device-resident callers use the JAX API directly anyway.
_THRESHOLD_ENV = os.environ.get("INTERPN_TPU_NATIVE_THRESHOLD")
NATIVE_THRESHOLD = int(_THRESHOLD_ENV) if _THRESHOLD_ENV else None

_lib = None
_tried = False

_VOIDP = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_DBL = ctypes.c_double


def _build_tag(src: bytes) -> str:
    """Build key: the source hash plus the host's CPU feature tag."""
    from ..config import host_feature_tag

    return f"{hashlib.sha256(src).hexdigest()[:16]}_{host_feature_tag()}"


def _lib_path() -> Path:
    return _DIR / f"libinterpn_native_{_build_tag(_SRC.read_bytes())}.so"


def _build() -> Path | None:
    out = _lib_path()
    if out.exists():
        return out
    # -ffp-contract=fast: allow FMA contraction, matching the reference's
    # shipped wheels (built with its `fma` feature). This is what makes the
    # reference's own cubic tests — which assert BITWISE equality at grid
    # points — pass against this backend (see
    # tests/test_reference_conformance.py); the JAX paths agree to the last
    # ulp rather than bit-for-bit.
    cmd = [
        "g++", "-O3", "-march=native", "-funroll-loops", "-ffp-contract=fast",
        "-std=c++17", "-shared", "-fPIC", "-pthread", str(_SRC), "-o", str(out),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except Exception:
        return None
    return out


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    # The dispatch env gate lives in use_native() (read per call, so a
    # transient =0 never bakes in) — but a g++ compile is NOT harmless:
    # with the backend disabled and no cached build on disk, skip the
    # build WITHOUT memoizing, so flipping the env back on re-attempts.
    if _native_mode() == "0" and not _lib_path().exists():
        return None
    _tried = True
    path = _build()
    if path is None:
        return None
    try:
        _lib = ctypes.CDLL(str(path))
    except OSError:
        _lib = None
    return _lib


_fastcall = None
_fastcall_tried = False


def _load_fastcall():
    """Build/import the _interpn_fastcall C extension (CPython C API call
    plumbing, see fastcall.c). Optional: everything works without it, just
    with ~10 us more per-call overhead from ctypes."""
    global _fastcall, _fastcall_tried
    if _fastcall_tried:
        return _fastcall
    import importlib.machinery
    import importlib.util
    import sysconfig

    src = _DIR / "fastcall.c"
    if not src.exists():  # source not shipped: ctypes path still works
        _fastcall_tried = True
        return None
    so = _DIR / f"_interpn_fastcall_{_build_tag(src.read_bytes())}.so"
    if _native_mode() == "0" and not so.exists():
        return None  # disabled + unbuilt: skip the compile, don't memoize
    _fastcall_tried = True
    if not so.exists():
        inc = sysconfig.get_paths()["include"]
        cmd = [
            "g++", "-O2", "-shared", "-fPIC", f"-I{inc}",
            "-x", "c", str(src), "-o", str(so),
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        except Exception:
            return None
    try:
        loader = importlib.machinery.ExtensionFileLoader("_interpn_fastcall", str(so))
        spec = importlib.util.spec_from_loader("_interpn_fastcall", loader)
        mod = importlib.util.module_from_spec(spec)
        loader.exec_module(mod)
        _fastcall = mod
    except Exception:
        _fastcall = None
    return _fastcall


def available() -> bool:
    return _load() is not None


def load_deferred() -> bool:
    """True while _load has skipped building (INTERPN_TPU_NATIVE=0 with no
    cached binary) without committing: callers should not memoize a
    native-unavailable result yet."""
    return not _tried


def set_threads(n: int | None) -> bool:
    """Set the evaluation thread count (None or <=0 restores auto: the
    INTERPN_TPU_NATIVE_THREADS env var, else hardware_concurrency capped at
    16). Threading shards the obs axis into contiguous ranges; results are
    bitwise identical to single-threaded evaluation."""
    lib = _load()
    if lib is None:
        return False
    lib.itn_set_threads(_INT(-1 if n is None or n <= 0 else int(n)))
    return True


# use_native sits on the per-call hot path of the reference's headline
# 1-observation regime; os.environ.get alone costs ~1.7 us per call (Mapping
# wrapper + key encode + value decode), so read the raw environment dict
# when the platform exposes it (~50 ns), keeping the documented per-call
# dynamism of INTERPN_TPU_NATIVE.
try:
    _ENVDATA = os.environ._data  # posix: {bytes: bytes}
    _NATIVE_KEY = os.fsencode("INTERPN_TPU_NATIVE")

    def _native_mode() -> str:
        v = _ENVDATA.get(_NATIVE_KEY)
        return "1" if v is None else os.fsdecode(v)
except AttributeError:  # pragma: no cover - non-posix environ layout

    def _native_mode() -> str:
        return os.environ.get("INTERPN_TPU_NATIVE", "1")


def use_native(n: int) -> bool:
    """Dispatch policy for host-resident (numpy) data.

    Default: always native when the backend built (see NATIVE_THRESHOLD
    above). INTERPN_TPU_NATIVE=0 disables; INTERPN_TPU_NATIVE_THRESHOLD=<n>
    restores a size crossover to the device path for deployments with fast
    host<->device links."""
    mode = _native_mode()
    if mode == "0":
        return False
    if mode == "always":
        return available()
    if NATIVE_THRESHOLD is not None and n >= NATIVE_THRESHOLD:
        return False
    return available()


def _c(a, dtype):
    return np.ascontiguousarray(np.asarray(a).ravel(), dtype=dtype)


def _obs_ptrs(obs, dtype):
    """(kept-alive converted arrays, c_void_p[] of their data pointers)."""
    arrs = [_c(o, dtype) for o in obs]
    ptrs = (_VOIDP * len(arrs))(*(a.ctypes.data for a in arrs))
    return arrs, ptrs


def _obs_dtype_mismatch(obs, dtype) -> bool:
    """True when any observation input is an ARRAY of any other dtype
    (the other float width, or an integer array). The prepared-call
    closures fall through on this so the class layer's general path
    raises the reference-parity TypeError (the monomorphized PyO3
    functions refuse such inputs, `src/python.rs:58-80`) instead of `_c`
    silently casting. Non-array inputs (lists, scalars) keep converting —
    a documented extension of the class API."""
    for o in obs:
        dt = getattr(o, "dtype", None)
        if dt is not None and dt != dtype:
            return True
    return False


def _fn_addr(fn) -> int:
    return ctypes.cast(fn, _VOIDP).value


def _compose(fast, slow):
    """Fast C-extension call with ctypes fallback (the fast path demands
    exact-dtype contiguous buffers; anything else falls through)."""
    if fast is None:
        return slow

    def call(obs, out) -> bool:
        if fast(obs, out):
            return True
        return slow(obs, out)

    return call




def _rc_result(rc: int) -> bool:
    """Map a kernel return code: 0 done, 2 raises the reference's
    unrepresentable-coordinate error (regular families only), else fall
    back to the JAX path."""
    if rc == 2:
        raise AssertionError("Unrepresentable coordinate value")
    return rc == 0


# ---------------------------------------------------------------------------
# prepared (grid-frozen) callables — used by the persistent model classes
# ---------------------------------------------------------------------------


def prepare_linear_regular(dims, starts, steps, vals, dtype):
    lib = _load()
    ndims = len(dims)
    if lib is None or ndims > 8:
        return None
    fn = lib.itn_linear_regular_f64 if dtype == np.float64 else lib.itn_linear_regular_f32
    d64 = np.asarray(dims, dtype=np.int64)
    st, sp, v = _c(starts, dtype), _c(steps, dtype), _c(vals, dtype)
    head = (_VOIDP(d64.ctypes.data), _INT(ndims), _VOIDP(st.ctypes.data), _VOIDP(sp.ctypes.data), _VOIDP(v.ctypes.data))
    keep = (d64, st, sp, v)

    def call(obs, out) -> bool:
        if out.dtype != dtype:
            return False  # raw pointer write would bit-reinterpret `out`
        if _obs_dtype_mismatch(obs, dtype):
            return False  # general path raises the reference TypeError
        arrs, ptrs = _obs_ptrs(obs, dtype)
        # the kernel loops n = out.size points over every obs pointer:
        # mismatched lengths would read out of bounds / truncate silently
        # (the reference errors "Dimension mismatch" — raised by the caller)
        if len(arrs) != ndims or any(a.size != out.size for a in arrs):
            return False
        rc = fn(*head, ptrs, _VOIDP(out.ctypes.data), _I64(out.size))
        del arrs  # kept alive through the C call; `keep` lives in the closure
        assert keep is not None
        return _rc_result(rc)

    fast = None
    fc = _load_fastcall()
    if fc is not None:
        fast = fc.prepare(
            _fn_addr(fn), 0, ndims, 0, 8 if dtype == np.float64 else 4,
            tuple(int(x) for x in d64), st.ctypes.data, sp.ctypes.data,
            None, v.ctypes.data, keep,
        )
    return _compose(fast, call)


def prepare_nearest_regular(dims, starts, steps, vals, dtype):
    lib = _load()
    ndims = len(dims)
    if lib is None or ndims > 6:
        return None
    fn = lib.itn_nearest_regular_f64 if dtype == np.float64 else lib.itn_nearest_regular_f32
    d64 = np.asarray(dims, dtype=np.int64)
    st, sp, v = _c(starts, dtype), _c(steps, dtype), _c(vals, dtype)
    head = (_VOIDP(d64.ctypes.data), _INT(ndims), _VOIDP(st.ctypes.data), _VOIDP(sp.ctypes.data), _VOIDP(v.ctypes.data))
    keep = (d64, st, sp, v)

    def call(obs, out) -> bool:
        if out.dtype != dtype:
            return False  # raw pointer write would bit-reinterpret `out`
        if _obs_dtype_mismatch(obs, dtype):
            return False  # general path raises the reference TypeError
        arrs, ptrs = _obs_ptrs(obs, dtype)
        # the kernel loops n = out.size points over every obs pointer:
        # mismatched lengths would read out of bounds / truncate silently
        # (the reference errors "Dimension mismatch" — raised by the caller)
        if len(arrs) != ndims or any(a.size != out.size for a in arrs):
            return False
        rc = fn(*head, ptrs, _VOIDP(out.ctypes.data), _I64(out.size))
        del arrs  # kept alive through the C call; `keep` lives in the closure
        assert keep is not None
        return _rc_result(rc)

    fast = None
    fc = _load_fastcall()
    if fc is not None:
        fast = fc.prepare(
            _fn_addr(fn), 0, ndims, 0, 8 if dtype == np.float64 else 4,
            tuple(int(x) for x in d64), st.ctypes.data, sp.ctypes.data,
            None, v.ctypes.data, keep,
        )
    return _compose(fast, call)


def prepare_cubic_regular(dims, starts, steps, vals, linearize, dtype):
    lib = _load()
    ndims = len(dims)
    if lib is None or ndims > 8:
        return None
    fn = lib.itn_cubic_regular_f64 if dtype == np.float64 else lib.itn_cubic_regular_f32
    d64 = np.asarray(dims, dtype=np.int64)
    st, sp, v = _c(starts, dtype), _c(steps, dtype), _c(vals, dtype)
    head = (
        _VOIDP(d64.ctypes.data), _INT(ndims), _VOIDP(st.ctypes.data),
        _VOIDP(sp.ctypes.data), _VOIDP(v.ctypes.data),
        _INT(1 if linearize else 0),
    )
    keep = (d64, st, sp, v)

    def call(obs, out) -> bool:
        if out.dtype != dtype:
            return False  # raw pointer write would bit-reinterpret `out`
        if _obs_dtype_mismatch(obs, dtype):
            return False  # general path raises the reference TypeError
        arrs, ptrs = _obs_ptrs(obs, dtype)
        # the kernel loops n = out.size points over every obs pointer:
        # mismatched lengths would read out of bounds / truncate silently
        # (the reference errors "Dimension mismatch" — raised by the caller)
        if len(arrs) != ndims or any(a.size != out.size for a in arrs):
            return False
        rc = fn(*head, ptrs, _VOIDP(out.ctypes.data), _I64(out.size))
        del arrs  # kept alive through the C call; `keep` lives in the closure
        assert keep is not None
        return _rc_result(rc)

    fast = None
    fc = _load_fastcall()
    if fc is not None:
        fast = fc.prepare(
            _fn_addr(fn), 1, ndims, 1 if linearize else 0,
            8 if dtype == np.float64 else 4,
            tuple(int(x) for x in d64), st.ctypes.data, sp.ctypes.data,
            None, v.ctypes.data, keep,
        )
    return _compose(fast, call)


def _prepare_rect(fn_name_64, fn_name_32, max_dims, grids, vals, dtype, extra=()):
    lib = _load()
    ndims = len(grids)
    if lib is None or ndims > max_dims:
        return None
    fn = getattr(lib, fn_name_64 if dtype == np.float64 else fn_name_32)
    gs = [_c(g, dtype) for g in grids]
    gptrs = (_VOIDP * ndims)(*(g.ctypes.data for g in gs))
    d64 = np.asarray([g.size for g in gs], dtype=np.int64)
    v = _c(vals, dtype)
    head = (gptrs, _VOIDP(d64.ctypes.data), _INT(ndims), _VOIDP(v.ctypes.data), *extra)
    keep = (gs, gptrs, d64, v)

    def call(obs, out) -> bool:
        if out.dtype != dtype:
            return False  # raw pointer write would bit-reinterpret `out`
        if _obs_dtype_mismatch(obs, dtype):
            return False  # general path raises the reference TypeError
        arrs, ptrs = _obs_ptrs(obs, dtype)
        # the kernel loops n = out.size points over every obs pointer:
        # mismatched lengths would read out of bounds / truncate silently
        # (the reference errors "Dimension mismatch" — raised by the caller)
        if len(arrs) != ndims or any(a.size != out.size for a in arrs):
            return False
        rc = fn(*head, ptrs, _VOIDP(out.ctypes.data), _I64(out.size))
        del arrs  # kept alive through the C call; `keep` lives in the closure
        assert keep is not None
        return _rc_result(rc)

    fast = None
    fc = _load_fastcall()
    if fc is not None:
        kind = 3 if extra else 2
        lin = int(extra[0].value) if extra else 0
        fast = fc.prepare(
            _fn_addr(fn), kind, ndims, lin, 8 if dtype == np.float64 else 4,
            tuple(int(x) for x in d64),
            0, 0, tuple(g.ctypes.data for g in gs), v.ctypes.data, keep,
        )
    return _compose(fast, call)


def prepare_linear_rectilinear(grids, vals, dtype):
    return _prepare_rect(
        "itn_linear_rectilinear_f64", "itn_linear_rectilinear_f32", 8,
        grids, vals, dtype,
    )


def prepare_nearest_rectilinear(grids, vals, dtype):
    return _prepare_rect(
        "itn_nearest_rectilinear_f64", "itn_nearest_rectilinear_f32", 6,
        grids, vals, dtype,
    )


def prepare_cubic_rectilinear(grids, vals, linearize, dtype):
    return _prepare_rect(
        "itn_cubic_rectilinear_f64", "itn_cubic_rectilinear_f32", 8,
        grids, vals, dtype, extra=(_INT(1 if linearize else 0),),
    )


# ---------------------------------------------------------------------------
# one-shot wrappers — used by the flat raw API
# ---------------------------------------------------------------------------


def _dtype_of(out):
    return out.dtype.type


def linear_regular(dims, starts, steps, vals, obs, out) -> bool:
    call = prepare_linear_regular(dims, starts, steps, vals, _dtype_of(out))
    return call is not None and call(obs, out)


def nearest_regular(dims, starts, steps, vals, obs, out) -> bool:
    call = prepare_nearest_regular(dims, starts, steps, vals, _dtype_of(out))
    return call is not None and call(obs, out)


def cubic_regular(dims, starts, steps, vals, linearize, obs, out) -> bool:
    call = prepare_cubic_regular(
        dims, starts, steps, vals, linearize, _dtype_of(out)
    )
    return call is not None and call(obs, out)


def linear_rectilinear(grids, vals, obs, out) -> bool:
    call = prepare_linear_rectilinear(grids, vals, _dtype_of(out))
    return call is not None and call(obs, out)


def nearest_rectilinear(grids, vals, obs, out) -> bool:
    call = prepare_nearest_rectilinear(grids, vals, _dtype_of(out))
    return call is not None and call(obs, out)


def cubic_rectilinear(grids, vals, linearize, obs, out) -> bool:
    call = prepare_cubic_rectilinear(grids, vals, linearize, _dtype_of(out))
    return call is not None and call(obs, out)


def check_bounds_regular(dims, starts, steps, obs, atol, out, dtype) -> bool:
    """Per-dimension bounds flags on the host (out: uint8/bool array).

    `dtype` is the compute dtype of the f32/f64 entry point that was called
    (NOT inferred from the input arrays): the reference computes the bound
    check strictly in the bound function's dtype, so f32 entry points must
    compare in f32 even when handed float64 inputs."""
    lib = _load()
    ndims = len(dims)
    if lib is None or ndims == 0:
        return False
    fn = (
        lib.itn_check_bounds_regular_f64
        if dtype == np.float64
        else lib.itn_check_bounds_regular_f32
    )
    d64 = np.asarray(dims, dtype=np.int64)
    st, sp = _c(starts, dtype), _c(steps, dtype)
    arrs, ptrs = _obs_ptrs(obs, dtype)
    n = arrs[0].size
    if any(a.size != n for a in arrs):
        # ragged obs are legal for check_bounds (the reference scans each
        # dimension over ITS OWN length); this kernel takes one n, which
        # would mis-scan — and read past shorter buffers. JAX path serves.
        return False
    flags = np.zeros(ndims, dtype=np.uint8)
    rc = fn(
        _VOIDP(d64.ctypes.data), ctypes.c_int(ndims), _VOIDP(st.ctypes.data),
        _VOIDP(sp.ctypes.data), ptrs, _DBL(float(atol)), _I64(n),
        _VOIDP(flags.ctypes.data),
    )
    if rc != 0:
        return False
    np.copyto(out, flags.astype(out.dtype))
    return True


def check_bounds_rectilinear(grids, obs, atol, out, dtype) -> bool:
    """See check_bounds_regular: `dtype` comes from the entry point called."""
    lib = _load()
    ndims = len(grids)
    if lib is None or ndims == 0:
        return False
    fn = (
        lib.itn_check_bounds_rectilinear_f64
        if dtype == np.float64
        else lib.itn_check_bounds_rectilinear_f32
    )
    gs = [_c(g, dtype) for g in grids]
    gptrs = (_VOIDP * ndims)(*(g.ctypes.data for g in gs))
    d64 = np.asarray([g.size for g in gs], dtype=np.int64)
    arrs, ptrs = _obs_ptrs(obs, dtype)
    n = arrs[0].size
    if any(a.size != n for a in arrs):
        return False  # ragged obs: see check_bounds_regular
    flags = np.zeros(ndims, dtype=np.uint8)
    rc = fn(
        gptrs, _VOIDP(d64.ctypes.data), ctypes.c_int(ndims), ptrs,
        _DBL(float(atol)), _I64(n), _VOIDP(flags.ctypes.data),
    )
    if rc != 0:
        return False
    np.copyto(out, flags.astype(out.dtype))
    return True
