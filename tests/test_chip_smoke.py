"""chip_smoke.py refuses to run without a GPU: non-zero exit, no ok line."""
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("alone", [False, True],
                         ids=["in_repo", "script_alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if alone:
        cwd = str(tmp_path)
        script = shutil.copy(script, cwd)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs an NVIDIA GPU" in r.stderr
