"""Runtime configuration for interpn-tpu.

The reference library (jlogan03/interpn) is f64-first: its Python API operates
on float64 by default and promises ~1e-13-level agreement on its tests. JAX
disables 64-bit types by default, so we enable x64 mode at import unless the
user opts out with INTERPN_TPU_NO_X64=1. All interpn-tpu code paths pass
explicit dtypes everywhere, so enabling x64 only *allows* f64 — it does not
change the dtype of any interpn-tpu result.
"""

from __future__ import annotations

import functools
import os

import jax


@functools.cache
def host_feature_tag() -> str:
    """Short fingerprint of this host's CPU feature set (plus jaxlib).

    Native code compiled with ``-march=native`` (``interpn_tpu.native``) is
    only safe on a host with the same ISA features: loading it elsewhere can
    end in SIGILL. Keying the build's file name by this tag turns a build
    copied from another host into a rebuild instead of a hazard."""
    import hashlib
    import platform

    feats = [platform.machine(), getattr(jax, "__version__", "")]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                # x86 exposes "flags", arm64 "Features"
                if line.startswith(("flags", "Features")):
                    feats.append(" ".join(sorted(line.split(":", 1)[1].split())))
                    break
    except OSError:  # pragma: no cover - non-procfs platforms
        pass
    return hashlib.blake2b("|".join(feats).encode(), digest_size=6).hexdigest()


# Fixed persistent-cache path inside the checkout (listed in .gitignore):
# the path is part of the cache key, so it must not move between processes.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def _setup() -> None:
    if os.environ.get("INTERPN_TPU_NO_X64", "0") not in ("1", "true", "True"):
        jax.config.update("jax_enable_x64", True)

    # Persistent XLA compilation cache: first compiles of large-batch
    # executables take seconds, and a warm cache makes later processes
    # start without them (see scripts/warm_cache.py). JAX itself reads
    # JAX_COMPILATION_CACHE_DIR; when it is set this module sets no other.
    # A process pinned to the CPU before import skips the default cache:
    # XLA:CPU AOT entries warn spuriously on load even on the same host.
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    if (getattr(jax.config, "jax_platforms", None) or "") == "cpu":
        return
    try:
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    except Exception:
        pass


_setup()

# Index dtype used for all cell-location and gather arithmetic. Grids are
# bounded well below 2^31 elements, so int32 indices suffice and halve the
# index traffic of int64.
INDEX_DTYPE = "int32"
