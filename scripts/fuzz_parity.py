"""Randomized cross-engine parity fuzzer.

Generates random (method x grid-kind x dtype x ndims) configurations with
queries spanning every saturation region and checks that ALL engines agree
with each other and with the loop-based numpy oracle: the native C++
engine, the JAX gather engine and the factorized engine (both grid kinds).

Run: python scripts/fuzz_parity.py [--rounds 50] [--seed 0]
Exit code != 0 on the first disagreement, printing a full repro.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

import oracle  # tests/oracle.py
from interpn_tpu import native
from interpn_tpu.ops import cubic as jcubic
from interpn_tpu.ops import factorized as fz
from interpn_tpu.ops import linear as jlinear
from interpn_tpu.ops import nearest as jnearest

import jax.numpy as jnp


def run_round(rng: np.random.Generator, idx: int) -> None:
    ndims = int(rng.integers(1, 7))
    method = rng.choice(["linear", "cubic", "nearest"])
    regular = bool(rng.integers(0, 2))
    dtype = rng.choice([np.float64, np.float32])
    linearize = bool(rng.integers(0, 2))
    min_pts = 4 if method == "cubic" else 2
    span = 4 if ndims <= 4 else 2  # keep 5-6D grids small enough to fuzz
    dims = [int(rng.integers(min_pts, min_pts + span)) for _ in range(ndims)]

    starts = rng.uniform(-3, 3, ndims)
    steps = rng.uniform(0.2, 2.0, ndims)
    # Bounded-conditioning rectilinear grids: cumsum of gaps with a floor.
    # Pure sort(uniform) can produce ~1e-6 spacings whose nonuniform cubic
    # slopes (~1/h) amplify f32 association-order noise to ~1e-3 — a
    # conditioning property, not an engine-agreement failure (fuzz-found
    # at 2D cubic f32: native vs factorized 7.7e-4 on a degenerate cell).
    grids = [
        np.cumsum(0.1 + rng.random(d)) + rng.uniform(-5, 0) for d in dims
    ]
    vals = rng.standard_normal(int(np.prod(dims)))

    n = 128
    if regular:
        obs = [
            rng.uniform(starts[k] - 3, starts[k] + steps[k] * (dims[k] + 3), n)
            for k in range(ndims)
        ]
    else:
        obs = [
            rng.uniform(g[0] - 0.5 * (g[-1] - g[0]), g[-1] + 0.5 * (g[-1] - g[0]), n)
            for g in grids
        ]

    # dtype-cast inputs
    starts_c = starts.astype(dtype)
    steps_c = steps.astype(dtype)
    grids_c = [g.astype(dtype) for g in grids]
    vals_c = vals.astype(dtype)
    obs_c = [o.astype(dtype) for o in obs]
    tol = 1e-11 if dtype == np.float64 else 1e-4

    engines = {}

    # native
    out = np.zeros(n, dtype)
    if regular:
        ok = {
            "linear": lambda: native.linear_regular(dims, starts_c, steps_c, vals_c, obs_c, out),
            "cubic": lambda: native.cubic_regular(dims, starts_c, steps_c, vals_c, linearize, obs_c, out),
            "nearest": lambda: native.nearest_regular(dims, starts_c, steps_c, vals_c, obs_c, out),
        }[method]()
    else:
        ok = {
            "linear": lambda: native.linear_rectilinear(grids_c, vals_c, obs_c, out),
            "cubic": lambda: native.cubic_rectilinear(grids_c, vals_c, linearize, obs_c, out),
            "nearest": lambda: native.nearest_rectilinear(grids_c, vals_c, obs_c, out),
        }[method]()
    if ok:
        engines["native"] = out.copy()

    # jax gather
    dims_t = tuple(dims)
    sj, stj = jnp.asarray(starts_c), jnp.asarray(steps_c)
    gj = tuple(jnp.asarray(g) for g in grids_c)
    vj = jnp.asarray(vals_c)
    oj = tuple(jnp.asarray(o) for o in obs_c)
    if regular:
        engines["gather"] = np.asarray(
            {
                "linear": lambda: jlinear.linear_regular(dims_t, sj, stj, vj, oj),
                "cubic": lambda: jcubic.cubic_regular(dims_t, sj, stj, vj, oj, linearize),
                "nearest": lambda: jnearest.nearest_regular(dims_t, sj, stj, vj, oj),
            }[method]()
        )
        engines["factorized"] = np.asarray(
            {
                "linear": lambda: fz.linear_regular_factorized(dims_t, sj, stj, vj, oj),
                "cubic": lambda: fz.cubic_regular_factorized(dims_t, sj, stj, vj, oj, linearize),
                "nearest": lambda: fz.nearest_regular_factorized(dims_t, sj, stj, vj, oj),
            }[method]()
        )
    else:
        engines["gather"] = np.asarray(
            {
                "linear": lambda: jlinear.linear_rectilinear(gj, vj, oj),
                "cubic": lambda: jcubic.cubic_rectilinear(gj, vj, oj, linearize),
                "nearest": lambda: jnearest.nearest_rectilinear(gj, vj, oj),
            }[method]()
        )
        engines["factorized"] = np.asarray(
            {
                "linear": lambda: fz.linear_rectilinear_factorized(gj, vj, oj),
                "cubic": lambda: fz.cubic_rectilinear_factorized(gj, vj, oj, linearize),
                "nearest": lambda: fz.nearest_rectilinear_factorized(gj, vj, oj),
            }[method]()
        )

    # oracle (f64 only: loop-based reference semantics)
    if dtype == np.float64:
        orc = {
            ("linear", True): lambda p: oracle.linear_regular(dims, starts_c, steps_c, vals_c, p),
            ("cubic", True): lambda p: oracle.cubic_regular(dims, starts_c, steps_c, vals_c, p, linearize),
            ("nearest", True): lambda p: oracle.nearest_regular(dims, starts_c, steps_c, vals_c, p),
            ("linear", False): lambda p: oracle.linear_rectilinear(grids_c, vals_c, p),
            ("cubic", False): lambda p: oracle.cubic_rectilinear(grids_c, vals_c, p, linearize),
            ("nearest", False): lambda p: oracle.nearest_rectilinear(grids_c, vals_c, p),
        }[(method, regular)]
        engines["oracle"] = np.array(
            [orc([o[i] for o in obs_c]) for i in range(n)]
        )

    # Every engine takes the same two-band tolerance: strict within one
    # cell, /100 beyond.
    mild = np.ones(n, bool)
    for k in range(ndims):
        if regular:
            lo = starts_c[k] - steps_c[k]
            hi = starts_c[k] + steps_c[k] * dims[k]
        else:
            span = grids_c[k][-1] - grids_c[k][0]
            lo = grids_c[k][0] - 0.2 * span
            hi = grids_c[k][-1] + 0.2 * span
        mild &= (obs_c[k] >= lo) & (obs_c[k] <= hi)

    names = list(engines)
    ref = engines[names[0]]
    scale = max(1.0, float(np.max(np.abs(ref))))
    for nm in names[1:]:
        # Deep multi-axis extrapolation amplifies association-order
        # noise by the stencil-term envelope (~|2t^3|^ndims for
        # cubic); engines differing only in evaluation order then
        # legitimately diverge past the flat tolerance in f32
        # (measured: 2.4e-4 native-vs-gather at 6D non-linearized
        # cubic, 3-cell extrapolation). Strict tolerance on
        # within-one-cell points; 100x allowance beyond.
        d_mild = (
            np.max(np.abs(engines[nm][mild] - ref[mild])) / scale
            if mild.any()
            else 0.0
        )
        d_wild = np.max(np.abs(engines[nm] - ref)) / scale
        d = max(d_mild, d_wild / 100.0)
        if not (d < tol):
            print(
                f"ROUND {idx} MISMATCH {names[0]} vs {nm}: rel {d:.3e}\n"
                f"  config: method={method} regular={regular} dtype={dtype.__name__}"
                f" ndims={ndims} dims={dims} linearize={linearize}"
            )
            sys.exit(1)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    for i in range(args.rounds):
        run_round(rng, i)
        if (i + 1) % 10 == 0:
            print(f"{i+1}/{args.rounds} rounds clean")
    print("ALL CLEAN")


if __name__ == "__main__":
    main()
