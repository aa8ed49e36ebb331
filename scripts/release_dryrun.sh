#!/usr/bin/env bash
# Local dry-run of the release pipeline's build steps (.github/workflows/
# release.yml can't execute in this environment — no runner). Mirrors:
# build sdist+wheel, install the wheel into a scratch prefix, import it
# away from the checkout, and warm the XLA cache from the installed copy.
# Run from the repo root: bash scripts/release_dryrun.sh
set -euo pipefail

work=$(mktemp -d)
trap 'rm -rf "$work"' EXIT
echo "== build sdist + wheel =="
# --no-build-isolation: zero-egress environments cannot fetch
# build deps; the installed setuptools satisfies pyproject.toml
python -m pip wheel --no-deps --no-build-isolation -w "$work/dist" . >/dev/null
(python -m build --sdist -o "$work/dist" >/dev/null 2>&1 && echo "sdist built") \
  || echo "sdist skipped (python-build not installed; wheel built via pip)"
ls -l "$work/dist"

echo "== install wheel into scratch prefix =="
whl=$(find "$work/dist" -name '*.whl' | head -1)
python -m pip install --target "$work/site" "$whl" --no-deps -q

echo "== import from the wheel (checkout shadowed) =="
(cd "$work" && PYTHONPATH="$work/site" python -c "
import interpn_tpu, numpy as np
assert '/site/' in interpn_tpu.__file__, interpn_tpu.__file__
out = interpn_tpu.interpn(
    [np.array([0.5, 1.5])] * 2,
    [np.arange(4.0)] * 2,
    np.arange(16.0).reshape(4, 4),
    method='linear',
)
print('wheel eval ok:', out)
")

echo "== warm-cache artifact (PGO-profile analogue) =="
JAX_COMPILATION_CACHE_DIR="$work/xla-cache" python scripts/warm_cache.py
du -sh "$work/xla-cache" 2>/dev/null || echo "(cache dir empty on this backend)"
echo "RELEASE DRY-RUN OK"
