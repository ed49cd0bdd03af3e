"""chip_smoke.py refuses to run without a GPU or without the repository: it
exits non-zero and prints no ``ok`` line."""

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_the_cpu():
    proc = _run(ROOT, os.path.join(ROOT, "chip_smoke.py"))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "GPU" in proc.stderr


def test_refuses_to_run_without_the_repository(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    proc = _run(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
