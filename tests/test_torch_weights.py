"""Reading the JAX package's committed checkpoint without JAX, and what the port
imports.

``read_jax_checkpoint`` runs in a subprocess in which a meta-path hook makes
every import of jax, jaxlib, flax, optax or chex raise; the converted params
then give the JAX package's float32 forward to 1e-5 (float32 sums in another
order, outputs of order 10).  A static check over the ASTs shows that no
module of the port, and not ``chip_smoke.py``, imports JAX, flax, optax,
matplotlib or the JAX package.
"""

import ast
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np

from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu.core import (
    graph as jgraph,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu.core.scene import (
    Scene as JScene,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu.models import (
    create_model as jcreate,
)
from extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu.train.checkpoint import (
    load_checkpoint,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPU = "extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu"
PORT = TPU + "_torch"
CKPT = os.path.join(REPO, "docs", "results", "fidelity_n100", "egnn_n100_ckpt_30_model.ckpt")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "chex", "matplotlib", TPU}

_CHILD = textwrap.dedent(
    """
    import json, sys
    import numpy as np

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "chex"):
                raise ImportError("blocked in this test: " + name)
            return None

    sys.meta_path.insert(0, Block())
    import torch
    from {port}.core.scene import Scene
    from {port}.core.graph import knn_mask
    from {port}.models import create_model
    from {port}.weights import params_from_jax, read_jax_checkpoint

    params = read_jax_checkpoint({ckpt!r})
    model = create_model("egnn_mc", device="cpu")
    model.load_state_dict(params_from_jax(params))
    arrs = np.load({inputs!r})
    scene = Scene(*(torch.from_numpy(arrs[k]) for k in ("pos", "vel", "force", "mass")))
    with torch.no_grad():
        out = model(scene, knn_mask(scene.pos, {k}))
    np.save({out!r}, out.numpy())
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax"))
    print(json.dumps(loaded))
    """
)


def test_read_checkpoint_without_jax_then_forward_matches(tmp_path):
    rng = np.random.default_rng(0)
    B, N, k = 2, 12, 11
    arrs = dict(
        pos=(rng.normal(size=(B, N, 3)) * (N / 5.0) ** (1 / 3)).astype(np.float32),
        vel=rng.normal(size=(B, N, 3)).astype(np.float32),
        force=np.zeros((B, N, 3), np.float32),
        mass=np.ones((B, N, 1), np.float32),
    )
    inputs, out = str(tmp_path / "inputs.npz"), str(tmp_path / "out.npy")
    np.savez(inputs, **arrs)
    code = _CHILD.format(port=PORT, ckpt=CKPT, inputs=inputs, out=out, k=k)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []

    params = load_checkpoint(CKPT)["params"]
    js = JScene(*(jnp.asarray(arrs[c]) for c in ("pos", "vel", "force", "mass")))
    want = np.asarray(jcreate("egnn_mc").apply(params, js, jgraph.knn_mask(js.pos, k)))
    np.testing.assert_allclose(np.load(out), want, rtol=1e-5, atol=1e-5)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_and_smoke_import_no_jax_nor_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, PORT)):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = [(os.path.relpath(f, REPO), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []
