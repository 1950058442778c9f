"""Host tools that start without torch, and TF32 off wherever torch is.

* Importing each host-only tool (``tools.pipeline``, ``tools.archive_row``,
  ``tools.results_report``, ``tools.diagnose_macros``, and
  ``tools.wait_for_backend``, whose probe is a subprocess) in a fresh
  process leaves ``"torch"`` out of ``sys.modules``: the package's
  ``__init__`` imports no torch, and torch comes in only where a call needs
  the device (the probe's subprocess, the CLI).  ``--help`` of each runs the
  same way, and so does the pipeline's wait under ``--device cpu``.
* Importing every module of each torch-using subpackage in a fresh process,
  after switching TF32 on, leaves ``torch.backends.cuda.matmul.allow_tf32``
  and ``torch.backends.cudnn.allow_tf32`` False: every module that imports
  torch imports ``_tf32`` first.
"""

import os
import subprocess
import sys

import pytest

PORT = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_TOOLS = ["pipeline", "archive_row", "results_report", "diagnose_macros",
              "wait_for_backend"]
TORCH_PACKAGES = ["core", "data", "evaluation", "hpo", "metrics", "models", "ops", "parallel",
                  "rollout", "train", "utils", "cli", "weights"]


def _run(code, *args):
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


@pytest.mark.parametrize("tool", HOST_TOOLS)
def test_host_tools_start_without_torch(tool):
    code = (f"import runpy, sys\nimport {PORT}.tools.{tool}\n"
            "assert 'torch' not in sys.modules, 'imported torch'\n"
            "sys.argv = ['tool', '--help']\n"
            "try:\n"
            f"    runpy.run_module('{PORT}.tools.{tool}', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code in (0, None), e.code\n"
            "assert 'torch' not in sys.modules, 'its --help imported torch'\n"
            "print('OK')")
    assert _run(code).strip().endswith("OK")


def test_the_pipelines_wait_imports_no_torch():
    code = (f"import sys\nfrom {PORT}.tools import pipeline\n"
            "assert pipeline._default_wait()(max_wait_s=60, probe_timeout_s=60, poll_s=1, "
            "platform='cpu', verbose=False)\n"
            "assert 'torch' not in sys.modules\nprint('OK')")
    assert _run(code).strip().endswith("OK")


@pytest.mark.parametrize("package", TORCH_PACKAGES)
def test_every_torch_module_switches_tf32_off(package):
    code = f"""
import importlib, pkgutil, torch
torch.backends.cuda.matmul.allow_tf32 = True
torch.backends.cudnn.allow_tf32 = True
assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
name = "{PORT}.{package}"
mod = importlib.import_module(name)
for info in pkgutil.walk_packages(getattr(mod, "__path__", []), name + "."):
    importlib.import_module(info.name)
assert not torch.backends.cuda.matmul.allow_tf32, "matmul TF32 on"
assert not torch.backends.cudnn.allow_tf32, "cuDNN TF32 on"
print("OK")
"""
    assert _run(code).strip().endswith("OK")
