"""Conformance: run the REFERENCE's own Python test suite against this
package.

The reference repo is mounted read-only at /root/reference; its tests import
`interpn`. We alias that name to `interpn_tpu` (same API surface by design)
and execute the reference's pytest files unmodified, in a subprocess. No
reference code is copied into this repo — the tests run from the mount and
this check simply skips where the mount is absent.

Excluded reference test files:
  * test_docs.py / test_examples.py — depend on mktestdocs/plotly (absent in
    this image) and on the reference's own README/examples.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REF_TESTS = Path("/root/reference/test")
REPO = Path(__file__).resolve().parent.parent

CONFORMANCE_FILES = [
    "test_interpn.py",
    "test_multilinear_regular.py",
    "test_multilinear_rectilinear.py",
    "test_multicubic_regular.py",
    "test_multicubic_rectilinear.py",
    "test_nearest_regular.py",
    "test_nearest_rectilinear.py",
]

pytestmark = pytest.mark.skipif(
    not REF_TESTS.exists(), reason="reference repo not mounted"
)


@pytest.fixture(scope="module")
def alias_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("interpn_alias")
    # `import interpn` resolves to interpn_tpu via module self-replacement.
    (d / "interpn.py").write_text(
        "import sys\n"
        "import interpn_tpu as _m\n"
        "sys.modules[__name__] = _m\n"
    )
    return d


@pytest.mark.parametrize("fname", CONFORMANCE_FILES)
def test_reference_file_passes(fname, alias_dir, tmp_path):
    src = REF_TESTS / fname
    if not src.exists():
        pytest.skip(f"{fname} not in reference")
    # Copy the single test file into a neutral directory so the reference
    # repo's own pytest configuration does not apply.
    workdir = tmp_path / "run"
    workdir.mkdir()
    shutil.copy(src, workdir / fname)
    env = {
        "PYTHONPATH": f"{alias_dir}:{REPO}",
        "PATH": "/usr/bin:/bin:/usr/local/bin",
        "HOME": str(tmp_path),
    }
    # Propagate the interpreter environment jax needs.
    import os

    for k, v in os.environ.items():
        env.setdefault(k, v)
    env["PYTHONPATH"] = f"{alias_dir}:{REPO}"
    # Pin the subprocess to the CPU backend before anything initializes jax;
    # the reference tests are tiny and the native CPU engine serves them
    # anyway.
    runner = (
        "import jax; jax.config.update('jax_platforms', 'cpu');"
        "import sys, pytest;"
        f"sys.exit(pytest.main([r'{workdir / fname}', '-q', '-p', 'no:cacheprovider']))"
    )
    res = subprocess.run(
        [sys.executable, "-c", runner],
        capture_output=True,
        text=True,
        timeout=600,
        env=env,
        cwd=str(workdir),
    )
    assert res.returncode == 0, (
        f"reference {fname} failed against interpn_tpu:\n{res.stdout}\n{res.stderr}"
    )
