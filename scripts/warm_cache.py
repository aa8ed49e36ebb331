"""Pre-compile hot configurations into the persistent XLA cache.

The JAX analogue of the reference's PGO pipeline
(`scripts/distr_pgo*.sh` + `scripts/profile_workload.py`): where the
reference re-compiles its Rust with a recorded profile, we ahead-of-time
compile the hot (method x dtype x ndims x batch-size) executables once and
let the persistent compilation cache (see interpn_tpu/config.py) serve every
later process.

The workload sweep mirrors scripts/profile_workload.py: dtypes x dims 1-4 x
batch sizes around the published benchmark configurations.

Run: python scripts/warm_cache.py [--sizes 1024,1048576]

The cache lands where JAX_COMPILATION_CACHE_DIR names, else in the fixed
`.jax_cache/` directory of the checkout (interpn_tpu/config.py).

Host portability: XLA:CPU AOT entries are valid only for the builder's CPU
feature set, so the release workflow names the uploaded artifact with
``interpn_tpu.config.host_feature_tag()``; a consumer installs it only on a
host with the same tag.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

import interpn_tpu  # noqa: F401
from interpn_tpu import ops


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="1024,65536,1048576")
    ap.add_argument("--max-dims", type=int, default=4)
    ap.add_argument("--quick", action="store_true",
                    help="CI smoke: one small size, 2 dims")
    args = ap.parse_args()
    sizes = [int(s) for s in args.sizes.split(",")]
    if args.quick:
        sizes = [1024]
        args.max_dims = 2

    rng = np.random.default_rng(0)
    for dtype in (jnp.float32, jnp.float64):
        for ndims in range(1, args.max_dims + 1):
            g = 20 if ndims <= 3 else 12
            dims = (g,) * ndims
            starts = jnp.zeros(ndims, dtype)
            steps = jnp.full(ndims, 0.5, dtype)
            vals = jnp.asarray(rng.standard_normal(g**ndims), dtype)
            grids = tuple(
                jnp.asarray(np.arange(g) * 0.5 + rng.uniform(0, 0.1), dtype)
                for _ in range(ndims)
            )
            for n in sizes:
                obs = tuple(
                    jnp.asarray(rng.uniform(-1, g * 0.5 + 1, n), dtype)
                    for _ in range(ndims)
                )
                t0 = time.perf_counter()
                jax.block_until_ready(
                    jax.jit(lambda o: ops.linear_regular(dims, starts, steps, vals, o))(obs)
                )
                jax.block_until_ready(
                    jax.jit(
                        lambda o: ops.cubic_regular(dims, starts, steps, vals, o, True)
                    )(obs)
                )
                jax.block_until_ready(
                    jax.jit(lambda o: ops.linear_rectilinear(grids, vals, o))(obs)
                )
                if ndims <= 6:
                    jax.block_until_ready(
                        jax.jit(
                            lambda o: ops.nearest_regular(dims, starts, steps, vals, o)
                        )(obs)
                    )
                print(
                    f"warmed {jnp.dtype(dtype).name} {ndims}D n={n}"
                    f" in {time.perf_counter()-t0:.1f}s"
                )


if __name__ == "__main__":
    main()
