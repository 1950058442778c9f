"""Inferencer: load a run dir once, then serve one-step predictions,
rollouts and scored evaluations.  Counterpart of the JAX package's
``rollout/inferencer.py``.

Single-step prediction uses the run's training graph (``num_neighbors``);
rollouts and evaluations are fully connected by default, as the trainer's
checkpoint evaluations and the self-feed CLI are, and take the run's
``self_feed_train_mode`` and ``self_feed_matmul_precision``, so the numbers
compare with the run's logged series.  A rollout function is kept per
``(num_steps, num_neighbors)``, where the JAX package keeps a jitted one.
Everything runs under ``torch.no_grad()``, so on the card the model's edge
stage is kernel K1.
"""

from __future__ import annotations

from typing import Optional, Tuple

from .. import _tf32  # noqa: F401  (TF32 off before torch is used)
import torch

from ..core import graph as G
from ..core.scene import Scene
from ..train.trainer import matmul_precision as _matmul_precision
from .self_feed import make_rollout_fn, run_self_feed


class Inferencer:
    def __init__(self, run_dir: str, checkpoint: str = "model.ckpt",
                 n_bodies: Optional[int] = None, device="cuda"):
        from ..train.restore import load_run

        self.model, self.dataset, self.args = load_run(
            run_dir, checkpoint=checkpoint, n_bodies=n_bodies, device=device
        )
        self.num_neighbors = (
            getattr(self.args, "num_neighbors", None) or self.dataset.num_nodes - 1
        )
        self.matmul_precision = getattr(self.args, "self_feed_matmul_precision", None)
        self.train_mode = bool(getattr(self.args, "self_feed_train_mode", True))
        self._rollouts = {}

    @torch.no_grad()
    def predict(self, scene: Scene) -> torch.Tensor:
        """One-step prediction ``[B, N, 3k]`` for a dense scene batch."""
        self.model.eval()
        mask = G.knn_mask(scene.pos, min(self.num_neighbors, scene.pos.shape[1] - 1))
        return self.model(scene, mask)

    def rollout(
        self, scene0: Scene, num_steps: int, rng=None,
        num_neighbors: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """Autoregressive rollout from ``scene0``: ``(loc [B,T,N,3],
        vel [B,T,N,3], steps_survived)``.  ``num_neighbors=None`` is fully
        connected; ``rng`` (an int, 0 for None) seeds the dropout masks of a
        model that draws them in the run's rollout mode (GraphTransformer or
        EquiformerV2 in training mode), fresh every step."""
        key = (num_steps, num_neighbors)
        if key not in self._rollouts:
            self._rollouts[key] = make_rollout_fn(
                self.model, num_steps, num_neighbors=num_neighbors, target=self.dataset.target
            )
        self.model.train(self.train_mode)
        with _matmul_precision(self.matmul_precision):
            loc, vel, survived = self._rollouts[key](scene0, rng)
        return loc, vel, int(survived.min())

    def evaluate(self, num_steps: Optional[int] = None, save_dir: Optional[str] = None,
                 rng=None, num_neighbors: Optional[int] = None):
        """Fresh GT, a rollout and the macro KS score:
        ``{"steps_survived", "per_macro", "combined"}``; with ``save_dir``, the
        artifacts of a checkpoint evaluation are written there too."""
        from ..metrics import artifacts
        from ..metrics import macros as M
        from ..metrics.ks import macro_ks_pvalues

        with _matmul_precision(self.matmul_precision):
            loc_gt, vel_gt, loc_pred, vel_pred, survived = run_self_feed(
                self.model, self.dataset, num_steps=num_steps, num_neighbors=num_neighbors,
                train_mode=self.train_mode, rng=rng,
            )
        if save_dir:
            per, combined, _, _ = artifacts.evaluate_rollout(
                save_dir, loc_gt, vel_gt, loc_pred, vel_pred
            )
        else:
            gt = M.compute_all_macros(artifacts.host(loc_gt), artifacts.host(vel_gt))
            pred = M.compute_all_macros(artifacts.host(loc_pred), artifacts.host(vel_pred))
            per, combined = macro_ks_pvalues(gt, pred)
        return {"steps_survived": survived, "per_macro": per, "combined": combined}
