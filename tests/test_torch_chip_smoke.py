"""``chip_smoke.py`` refuses to run without a GPU: no fallback to the CPU."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

SCRIPT = Path(__file__).resolve().parents[1] / "chip_smoke.py"


def _run(script: Path, cwd: Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    out = _run(SCRIPT, SCRIPT.parent)
    assert out.returncode != 0
    assert "no CUDA GPU" in out.stderr
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(SCRIPT, alone)
    out = _run(alone, tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
