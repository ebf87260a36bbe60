"""chip_smoke.py must refuse to report a result without a GPU: it exits
non-zero and never prints the `"ok": true` line, both on a CPU-only JAX and
from a directory holding the script and nothing else of the repository."""
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    r = _run(SCRIPT, ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_fails_alone(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(SCRIPT, lone)
    r = _run(str(lone), str(tmp_path))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
