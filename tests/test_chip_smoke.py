"""chip_smoke.py refuses to run without a GPU: non-zero exit, no result."""

import os
import shutil
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("alone", [False, True])
def test_exits_nonzero_without_gpu(tmp_path, alone):
    """On the CPU, from the checkout or alone in an empty directory."""
    if alone:
        cwd = str(tmp_path)
        shutil.copy(os.path.join(_REPO, "chip_smoke.py"), cwd)
    else:
        cwd = _REPO
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
