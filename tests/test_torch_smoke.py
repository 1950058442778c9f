"""``chip_smoke.py`` refuses to report a result without a card or without the repo.

On a machine where ``torch.cuda.is_available()`` is False it must exit
non-zero and print no ``"ok"`` line; so must a copy of the script alone in an
empty directory (the port's package is then missing).
"""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "chip_smoke.py")


def test_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, SMOKE], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and "CUDA" in res.stderr


def test_smoke_fails_alone_in_an_empty_directory(tmp_path):
    """Even where CUDA is reported available, the lone script stops at the
    missing package."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(SMOKE, lone)
    code = ("import runpy, torch; torch.cuda.is_available = lambda: True; "
            f"runpy.run_path({str(lone)!r}, run_name='__main__')")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(tmp_path), timeout=120)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    assert "not importable" in res.stderr
    assert sorted(os.listdir(tmp_path)) == ["chip_smoke.py"]
