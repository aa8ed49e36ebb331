"""Ahead-of-time compiled serving artifacts (extension).

The reference ships PGO-optimized wheels so production binaries never pay
the profile cost at run time (`/root/reference/.github/workflows/
release-python.yml:36-88`). The JAX analogue of "never pay compilation in
production" has two tiers: the persistent XLA compile cache
(`interpn_tpu.config`, `scripts/warm_cache.py`) and — this module — real
ahead-of-time artifacts: `jax.export` serializes the lowered StableHLO of a
model's device evaluation (grid table baked in as constants) to bytes that
a serving process deserializes and calls WITHOUT the pydantic model, the
dispatch layer, or any retracing.

Design:

* An artifact holds one exported executable per **batch-size bucket**
  (static shapes are what XLA compiles; a serving batch is padded to the
  smallest bucket that fits and the pad is sliced off). Bucket padding
  replicates the batch's own first coordinate, so it cannot introduce
  out-of-domain or non-finite work.
* Engine choice is pinned at export time: the dispatcher picks the engine
  while tracing, and the chosen engine rides inside the artifact
  (`platforms=["cuda"]` exports for the GPU from any host).
* `eval_jax` semantics (`models/_base.py:196-203`): invalid coordinates
  propagate as NaN; nothing raises per-point on device.

Wire format: `ITAOT1\n` magic, 8-byte big-endian JSON-header length, JSON
header {class, ndims, dtype, batch_sizes, platforms, jax}, then each
bucket's `jax.export` blob length-prefixed in header order.
"""

from __future__ import annotations

import json
import struct
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import export as _jexport

_MAGIC = b"ITAOT1\n"


def export_eval(model, batch_sizes, *, platforms: Sequence[str] | None = None) -> bytes:
    """Serialize `model`'s device evaluation into a self-contained artifact.

    Args:
        model: any of the six interpolator classes (constructed/validated).
        batch_sizes: one int or a sequence of ints — the observation-count
            buckets to compile. More buckets = less padding waste at serve
            time, one compiled program each.
        platforms: lowering platforms (e.g. ["cuda"], ["cpu", "cuda"]).
            Defaults to the current default backend. The ENGINE is chosen
            by the dispatcher at trace time (INTERPN_TPU_IMPL forces one).

    Returns:
        bytes — write to disk/object store; load with `aot.load`.
    """
    sizes = [int(batch_sizes)] if np.isscalar(batch_sizes) else sorted(
        {int(n) for n in batch_sizes}
    )
    if not sizes or any(n < 1 for n in sizes):
        raise ValueError("batch_sizes must be positive")
    dtype = jnp.float64 if model._dtype == np.float64 else jnp.float32
    ndims = model.ndims()
    model._check_grid_sizes()
    dev = model._dev_cache()

    def fn(*obs):
        return model._eval_device_full(dev, tuple(obs))[0]

    plats = list(platforms) if platforms is not None else None
    blobs = []
    for n in sizes:
        args = tuple(jax.ShapeDtypeStruct((n,), dtype) for _ in range(ndims))
        exp = _jexport.export(jax.jit(fn), platforms=plats)(*args)
        blobs.append(exp.serialize())

    header = json.dumps(
        {
            "class": type(model).__name__,
            "ndims": ndims,
            "dtype": "float64" if dtype == jnp.float64 else "float32",
            "batch_sizes": sizes,
            "platforms": plats or [jax.default_backend()],
            "jax": jax.__version__,
        }
    ).encode()
    out = [_MAGIC, struct.pack(">Q", len(header)), header]
    for b in blobs:
        out.append(struct.pack(">Q", len(b)))
        out.append(b)
    return b"".join(out)


class ServingModel:
    """A deserialized artifact: callable evaluation, no model required.

    `eval_jax(obs)` pads the batch to the smallest compiled bucket and
    slices the pad off — accepts any length up to the largest bucket.
    """

    def __init__(self, meta: dict, exported: list):
        self.meta = meta
        self.ndims = int(meta["ndims"])
        self.dtype = jnp.float64 if meta["dtype"] == "float64" else jnp.float32
        self.batch_sizes = [int(n) for n in meta["batch_sizes"]]
        self._calls = {
            n: e.call for n, e in zip(self.batch_sizes, exported, strict=True)
        }

    def __repr__(self):
        return (
            f"ServingModel({self.meta['class']}, ndims={self.ndims}, "
            f"dtype={self.meta['dtype']}, batch_sizes={self.batch_sizes})"
        )

    def eval_jax(self, obs) -> jax.Array:
        if len(obs) != self.ndims:
            raise AssertionError("Dimension mismatch")
        obs_j = [jnp.asarray(x, dtype=self.dtype).ravel() for x in obs]
        n = int(obs_j[0].shape[0])
        for x in obs_j[1:]:
            if int(x.shape[0]) != n:
                raise AssertionError("Dimension mismatch")
        if n == 0:
            return jnp.zeros((0,), dtype=self.dtype)
        bucket = next((b for b in self.batch_sizes if b >= n), None)
        if bucket is None:
            raise ValueError(
                f"batch of {n} exceeds the largest compiled bucket "
                f"{self.batch_sizes[-1]}; re-export with a larger bucket"
            )
        if bucket != n:
            obs_j = [
                jnp.concatenate([x, jnp.broadcast_to(x[0], (bucket - n,))])
                for x in obs_j
            ]
        res = self._calls[bucket](*obs_j)
        return res[:n] if bucket != n else res

    __call__ = eval_jax


def load(blob: bytes) -> ServingModel:
    """Deserialize an `export_eval` artifact (same-or-newer jax required
    by jax.export's compatibility window)."""
    if not blob.startswith(_MAGIC):
        raise ValueError("not an interpn-tpu AOT artifact")
    off = len(_MAGIC)
    (hlen,) = struct.unpack(">Q", blob[off : off + 8])
    off += 8
    meta = json.loads(blob[off : off + hlen].decode())
    off += hlen
    exported = []
    for _ in meta["batch_sizes"]:
        (blen,) = struct.unpack(">Q", blob[off : off + 8])
        off += 8
        exported.append(_jexport.deserialize(blob[off : off + blen]))
        off += blen
    return ServingModel(meta, exported)
