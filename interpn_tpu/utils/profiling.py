"""Profiling and timing helpers (the reference's tracing subsystem analogue:
criterion benches + timeit harness, SURVEY.md §5 row 1 — here built on
jax.profiler and a memoization-proof device timer).
"""

from __future__ import annotations

import contextlib
import tempfile
import time

import jax
import jax.numpy as jnp


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Capture a jax.profiler trace of the enclosed block (view with
    TensorBoard or xprof). Without `log_dir` a fresh temporary directory
    is used; the directory is yielded."""
    if log_dir is None:
        log_dir = tempfile.mkdtemp(prefix="interpn_trace_")
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def device_timeit(kernel, obs_sets, *, reps: int | None = None) -> float:
    """Seconds per evaluation of `kernel(obs_tuple)` measured on device.

    `obs_sets` is a stacked array (R, ndims, n) of R DISTINCT observation
    batches; the kernel is scanned over them inside one jit. Distinct inputs
    keep a runtime that caches execution results from timing a cache hit,
    and the scan amortizes per-call dispatch overhead.
    """
    r = obs_sets.shape[0] if reps is None else reps

    @jax.jit
    def run(stack):
        def body(acc, ob):
            out = kernel(tuple(ob))
            # FULL reduction, not out[0] + out[-1]: a sliced reduction lets
            # XLA push the slice through elementwise paths and dead-code
            # eliminate virtually all of the work being timed.
            return acc + jnp.sum(out), None

        acc, _ = jax.lax.scan(body, jnp.zeros((), stack.dtype), stack)
        return acc

    jax.block_until_ready(run(obs_sets))  # compile + warm
    t0 = time.perf_counter()
    jax.block_until_ready(run(obs_sets))
    return (time.perf_counter() - t0) / r


def compiled_hlo(fn, *args, **kwargs) -> str:
    """Compiled HLO text of jit(fn)(*args) — for inspecting fusion and
    confirming the absence of collectives on sharded paths."""
    return jax.jit(fn).lower(*args, **kwargs).compile().as_text()


def _leaf_event_total(log_dir: str, match: str) -> float:
    """Microseconds summed over LEAF matching events in a profiler dump.

    The trace nests (a jit parent event wraps each launch event, under a
    different name): keep only matching events that do not strictly contain
    another matching event on the same (pid, tid) lane, and sum them.
    Parents are excluded (no double-counting); sequential sibling kernels —
    same-named chunked launches or a differently-named tail kernel — all
    count."""
    import glob
    import gzip
    import json

    events: list = []
    for f in glob.glob(log_dir + "/**/*.trace.json.gz", recursive=True):
        with gzip.open(f) as fh:
            for e in json.load(fh).get("traceEvents", []):
                if e.get("ph") == "X" and match in e.get("name", ""):
                    events.append(
                        (
                            (e.get("pid"), e.get("tid")),
                            float(e.get("ts", 0.0)),
                            float(e.get("dur", 0.0)),
                        )
                    )

    def _is_parent(ev):
        lane, ts, dur = ev
        # strict containment only: coincident duplicates are not parents of
        # each other (else both would vanish)
        return any(
            o[0] == lane
            and o[1] >= ts
            and o[1] + o[2] <= ts + dur
            and (o[1] > ts or o[1] + o[2] < ts + dur)
            for o in events
        )

    return sum(ev[2] for ev in events if not _is_parent(ev))


def device_kernel_time(fn, *, match: str, log_dir: str | None = None) -> float:
    """Seconds of device time summed over trace events whose name contains
    `match`, for one traced call of `fn()`.

    `fn` should block on its result. Durations are summed over LEAF events
    (matching events that contain no other matching event on the same
    trace lane), so chunked evaluations (several same-named launches) and
    multi-kernel evals (a main kernel plus a differently-named tail kernel)
    both report their full device time without double-counting nesting
    jit parent events. Without `log_dir` a fresh temporary directory holds
    the trace.

    Raises RuntimeError when no matching device event was captured."""
    import shutil

    fn()  # compile + warm outside the trace
    if log_dir is None:
        log_dir = tempfile.mkdtemp(prefix="interpn_ktrace_")
    shutil.rmtree(log_dir, ignore_errors=True)
    jax.profiler.start_trace(log_dir)
    try:
        fn()
    finally:
        jax.profiler.stop_trace()
    total = _leaf_event_total(log_dir, match)
    if total == 0.0:
        raise RuntimeError(f"no device event matching {match!r} captured")
    return total * 1e-6


def card_info() -> str:
    """The cards' names and power limits, one line per card, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them. A card may run below its maximum power, and then slower under
    load, so every timing is reported beside this line."""
    import subprocess

    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return res.stdout.strip()
