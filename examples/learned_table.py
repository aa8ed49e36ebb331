"""Differentiable look-up tables: fit an interpolation table to data.

The table of a :class:`interpn_tpu.functional.JaxInterpolator` is a pytree
leaf, so it is a trainable parameter like any other: gradients flow from a
loss through the interpolation kernels into the table entries (the
dispatch layer routes autodiff through the exact gather-tree JVP). This
example distills a nonlinear function into a compact cubic table with
optax — the classic "learned look-up table" pattern used for activation
tables, tone-mapping curves, and calibration maps — in one `lax.scan`-
compiled training loop.

The reference library has no analogue (no autodiff); this is a JAX-only
surface: jit once, scan the optimizer, swap tables without retracing.

Run: python examples/learned_table.py
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np
import optax

from interpn_tpu.functional import JaxInterpolator

STEPS = 400
N_TRAIN = 4096
TABLE_N = 16  # 16x16 cubic table


def target(x, y):
    return jnp.sin(3.0 * x) * jnp.cos(2.0 * y) + 0.5 * x * y


def main() -> None:
    rng = np.random.default_rng(0)
    obs = [
        jnp.asarray(rng.uniform(0.0, 1.0, N_TRAIN)),
        jnp.asarray(rng.uniform(0.0, 1.0, N_TRAIN)),
    ]
    y = target(obs[0], obs[1]) + 0.02 * jnp.asarray(
        rng.standard_normal(N_TRAIN)
    )

    dims = (TABLE_N, TABLE_N)
    step = 1.0 / (TABLE_N - 1)
    itp = JaxInterpolator.regular(
        dims, np.zeros(2), np.full(2, step), np.zeros(TABLE_N * TABLE_N),
        method="cubic",
    )
    leaves, treedef = jax.tree_util.tree_flatten(itp)
    fixed = leaves[:-1]  # starts/steps stay frozen; the table trains

    def predict(table, obs):
        model = jax.tree_util.tree_unflatten(treedef, [*fixed, table])
        return model(obs)

    def loss(table):
        return jnp.mean((predict(table, obs) - y) ** 2)

    opt = optax.adam(3e-2)

    @jax.jit
    def fit(table):
        state = opt.init(table)

        def one_step(carry, _):
            table, state = carry
            l, g = jax.value_and_grad(loss)(table)
            updates, state = opt.update(g, state)
            return (optax.apply_updates(table, updates), state), l

        (table, _), losses = jax.lax.scan(
            one_step, (table, state), None, length=STEPS
        )
        return table, losses

    table, losses = fit(itp.vals)

    # held-out validation against the clean target
    val = [
        jnp.asarray(rng.uniform(0.0, 1.0, 8192)),
        jnp.asarray(rng.uniform(0.0, 1.0, 8192)),
    ]
    truth = target(val[0], val[1])
    rmse0 = float(jnp.sqrt(jnp.mean((predict(itp.vals, val) - truth) ** 2)))
    rmse = float(jnp.sqrt(jnp.mean((predict(table, val) - truth) ** 2)))
    print(f"train loss: {float(losses[0]):.4f} -> {float(losses[-1]):.5f}")
    print(f"held-out RMSE vs clean target: {rmse0:.4f} -> {rmse:.5f}")
    assert rmse < 0.05 * rmse0, (rmse, rmse0)
    # the fitted table now serves at full engine speed like any other
    # interpolator — and can be shipped via the pydantic classes:
    import interpn_tpu as it

    model = it.MulticubicRegular.new(
        list(dims), np.zeros(2), np.full(2, step), np.asarray(table)
    )
    blob = model.model_dump_json()
    print(f"serialized fitted table: {len(blob)} bytes of reference-format JSON")


if __name__ == "__main__":
    main()
