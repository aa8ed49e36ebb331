"""Device-resident serving pipeline: the device-native way to use interpn-tpu.

Demonstrates the high-throughput path end to end: build an interpolator,
precompile for the serving batch size, evaluate device-resident queries with
zero host round-trips, take gradients, and (when more than one device is
visible) shard the query axis across a mesh.

Run: python examples/device_pipeline.py
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

import interpn_tpu as it
from interpn_tpu import parallel

BATCH = 1 << 20


def main() -> None:
    rng = np.random.default_rng(0)
    n_grid = 20
    x = np.linspace(0.0, 10.0, n_grid)
    mesh_np = np.meshgrid(x, x, x, indexing="ij")
    vals = (np.sin(mesh_np[0]) + mesh_np[1] * mesh_np[2]).astype(np.float32)

    interp = it.MulticubicRegular.new(
        [n_grid] * 3,
        np.zeros(3, np.float32),
        np.full(3, x[1] - x[0], np.float32),
        vals.ravel(),
    )

    batch = BATCH
    interp.warmup(batch)  # compile before taking traffic

    # Device-resident queries (e.g. produced by an upstream jitted stage).
    key = jax.random.key(0)
    obs = tuple(
        jax.random.uniform(k, (batch,), jnp.float32, -0.5, 10.5)
        for k in jax.random.split(key, 3)
    )

    t0 = time.perf_counter()
    out = interp.eval_jax(obs)
    jax.block_until_ready(out)
    print(f"eval_jax: {batch:,} points in {(time.perf_counter()-t0)*1e3:.1f} ms")

    gx, gy, gz = interp.gradient_jax(obs)
    print("gradient_jax shapes:", gx.shape, gy.shape, gz.shape)

    devices = jax.devices()
    if len(devices) > 1:
        mesh = parallel.make_mesh(devices)
        f = parallel.sharded_evaluator(mesh, method="cubic", regular=True)
        obs_sh = parallel.shard_obs(obs, mesh)
        out_sh = f(
            (np.zeros(3, np.float32), np.full(3, x[1] - x[0], np.float32)),
            vals.ravel(),
            obs_sh,
            dims=(n_grid,) * 3,
        )
        print("sharded over", len(devices), "devices:", out_sh.sharding.spec)
    else:
        print("single device; sharded path exercised in tests on a CPU mesh")


if __name__ == "__main__":
    main()
