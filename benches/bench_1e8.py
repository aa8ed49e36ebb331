"""1e8-observation sweep (BASELINE.json config: "multi-chip query-sharded
1e8-obs sweep").

Observations are generated on-device (jax.random) so the measurement reflects
device throughput, not the host link. On a multi-chip mesh the same code
shards the query axis with zero collectives; on one device it runs the
gather tree end-to-end at scale.

Run: python benches/bench_1e8.py [--n 100000000] [--method cubic]
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
from interpn_tpu import ops, parallel


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000_000)
    ap.add_argument("--method", default="cubic", choices=["linear", "cubic", "nearest"])
    ap.add_argument("--grid", type=int, default=20)
    args = ap.parse_args()

    g = args.grid
    dims = (g, g, g)
    x = np.linspace(0.0, 10.0, g)
    mesh_np = np.meshgrid(x, x, x, indexing="ij")
    vals = jnp.asarray((np.sin(mesh_np[0]) + mesh_np[1] * mesh_np[2]).ravel(), jnp.float32)
    starts = jnp.zeros(3, jnp.float32)
    steps = jnp.full(3, x[1] - x[0], jnp.float32)

    devices = jax.devices()
    mesh = parallel.make_mesh(devices)
    n = (args.n // len(devices)) * len(devices)

    kern = {
        "linear": lambda o: ops.linear_regular(dims, starts, steps, vals, o),
        "cubic": lambda o: ops.cubic_regular(dims, starts, steps, vals, o, True),
        "nearest": lambda o: ops.nearest_regular(dims, starts, steps, vals, o),
    }[args.method]

    shd = parallel.obs_sharding(mesh)

    @jax.jit
    def run(key):
        ks = jax.random.split(key, 3)
        obs = tuple(
            jax.lax.with_sharding_constraint(
                jax.random.uniform(k, (n,), jnp.float32, -0.5, 10.5), shd
            )
            for k in ks
        )
        out = kern(obs)
        # reduce so only a scalar returns to the host
        return jnp.sum(out), out[0]

    s0, _ = run(jax.random.key(0))
    jax.block_until_ready(s0)  # compile + warm
    t0 = time.perf_counter()
    s1, _ = run(jax.random.key(1))
    jax.block_until_ready(s1)
    dt = time.perf_counter() - t0
    print(
        f"{args.method} 3D f32, n={n:,} on {len(devices)} device(s):"
        f" {dt*1e3:.1f} ms -> {n/dt/1e6:.1f} Mq/s (incl. on-device RNG)"
    )


if __name__ == "__main__":
    main()
