"""The training loop on one device: counterpart of the JAX package's
``train/trainer.py``.

A training step featurises, runs the model (a model with an edge stage,
EGNN-MC, through its dense form, ``edge_impl="dense"``, which autograd
differentiates: the edge kernels have no backward, and the JAX trainer
differentiates its own XLA edge stage too), takes the loss, backward, and one
update of AdamW under the Noam schedule
(``train.optim``).  Nothing in it waits on the device: the step's metric
vector stays there, and an epoch fetches its steps' vectors once.  Every
``test_macros_every`` epochs the run scores itself: a self-feed rollout through
the model's configured edge stage (kernel K1 on the card) under
``torch.no_grad()``, then the macro and energy KS tests, with the JAX
package's run-dir artifacts.

Epochs, metric names, checkpoints, crash handling, the run-dir layout
(``runs/<model>/<timestamp>[__<run_name>]``) and the per-layer debug statistics
(``debug_layer_stats_every``, ``evaluation.layer_stats``) are the JAX
trainer's, and so is PONITA's one-time calibration of its convolution kernels
on the first training batch (``models.ponita.calibrate_params``), before a
checkpoint is loaded over it.  A dataset whose ``get_batch`` returns three
items, ``(scene, y, mask)`` (the offline charged systems'), trains,
validates, calibrates and logs layer statistics on the mask the data
carries, never on the kNN mask; it has no ground-truth trajectories, so its
run cannot score itself by self-feed (set ``test_macros_every`` past the
run's epochs).  A model with live dropout (GraphTransformer,
EquiformerV2) draws each step's masks from one ``torch.Generator`` on the
device, seeded with the run's ``seed`` (0 without one; plus the rank in a
data-parallel run), where the JAX trainer splits a key a step: the streams
differ, and the same seed gives the same run.

**Several ranks** (a ``torch.distributed`` group of world size K > 1, as
``torchrun`` or ``parallel.launch.spawn_ranks`` sets up; the JAX trainer's
mesh, ``train/trainer.py:100-114``): with ``data_parallel`` on and the
batch divisible by K, the run is data parallel over the sims
(``parallel.sharded``).  Every rank draws the same whole batch (the
dataset's generator and frame order are the first rank's) and trains its
B/K rows; one ``all_reduce`` a step averages the gradients, so the
clipping, the skip of a non-finite update and AdamW run on the same numbers
everywhere; the evaluation rollout shards the sims (``run_self_feed(...,
mesh=...)``) and the first rank scores it and hands the outcome to the
others.  Otherwise every rank trains the whole batch (a line says which).
Either way only the first rank writes: the run dir, logs, checkpoints,
evaluation artifacts and the GT cache.

On the card the edge kernels K1 and K3 compute float32 (or bf16 operands),
taking a bf16 scene's geometry as float32, so a ``bfloat16`` or ``autocast``
run evaluates through them; a ``double`` run there needs the model's
``edge_impl="dense"``.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import time
import traceback
from typing import Dict, Optional

import numpy as np
import torch

from ..core import graph as G
from ..core.physics import energy_series
from ..core.scene import Scene
from ..data.gravity_otf import GravityDatasetOtf
from ..evaluation import layer_stats
from ..metrics import artifacts
from ..metrics.ks import fisher_combine, ks_p
from ..models import count_params, create_model, has_edge_stage, needs_generator
from ..models.ponita import calibrate_params
from ..ops import _build
from ..parallel import mesh as pmesh
from ..parallel.sharded import make_sharded_train_step, shard_scene
from ..rollout.self_feed import run_self_feed
from ..utils.config import save_config
from ..weights import opt_state_from_jax, params_from_jax, params_to_jax, skip_counts_from_jax
from .checkpoint import load_checkpoint, optax_opt_state, save_checkpoint
from .logging_utils import MetricsLogger, RunningMean
from .losses import build_loss_fn, percentage_errors
from .optim import NoamAdamW, create_optimizer
from .restore import write_run_files

ENERGY_ERROR_THRESHOLDS = [2.5, 5]

# the JAX matmul precisions that let a GPU's float32 products drop to TF32
TF32_PRECISIONS = ("default", "fastest", "high", "tensorfloat32", "bfloat16", "bfloat16_3x")


def resolve_dtype(precision_mode: str) -> torch.dtype:
    """The compute dtype of a ``precision_mode``; ``autocast`` computes in bf16
    as the JAX package's does."""
    return {
        "double": torch.float64,
        "single": torch.float32,
        "bfloat16": torch.bfloat16,
        "autocast": torch.bfloat16,
    }[precision_mode]


def set_matmul_precision(precision: Optional[str]) -> None:
    """TF32 on for the matmul precisions that allow it, off otherwise (the
    ``float32`` default and None): process-global, as JAX's setting is."""
    allow = precision in TF32_PRECISIONS
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow


@contextlib.contextmanager
def matmul_precision(precision: Optional[str]):
    """``set_matmul_precision(precision)`` inside the block when it is given."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    if precision:
        set_matmul_precision(precision)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def make_train_step(model, optim: NoamAdamW, loss_fn, targets, num_neighbors: int,
                    dtype: torch.dtype, abort_on_nan: bool = False,
                    generator: Optional[torch.Generator] = None, group=None, forward=None,
                    grad_divisor: Optional[int] = None):
    """``(step, metric_names)``: ``step(scene, y, mask=None)`` takes one
    optimizer step on ``mask`` (the ``num_neighbors`` nearest bodies where
    None) (through the dense edge stage, for a model with one) and returns the
    metric vector ``[loss, *sorted(terms), *sorted(percentage errors)]``
    (float32, on the device); ``metric_names`` fills at the first call.
    ``abort_on_nan`` skips an update whose prediction is not finite, decided
    on the device.  ``generator`` draws the dropout masks of a model that has
    live dropout in training mode.  ``group`` (data parallel: each rank's
    ``scene`` its rows) averages the gradients, the metric vector and the
    non-finite flag over its ranks before the update
    (``parallel.sharded.average_step``; ``grad_divisor`` divides the summed
    gradients in place of the group's size).  ``forward(scene, y) -> (pred,
    scene, y)`` stands in for the model's call on the kNN mask: the
    body-sharded step's, whose ranks take their rows and return the whole
    sims' prediction, scene and targets, so that the loss and the metrics are
    the whole sims'."""
    from ..parallel.sharded import average_step

    metric_names: list = []
    dense = {"edge_impl": "dense"} if has_edge_stage(model) else {}

    def step(scene: Scene, y: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        scene, y = scene.astype(dtype), y.to(dtype)
        model.train()
        if forward is not None:
            pred, scene, y = forward(scene, y)
        else:
            if mask is None:
                mask = G.knn_mask(scene.pos, num_neighbors)
            dropout = {"generator": generator} if needs_generator(model) else {}
            pred = model(scene, mask, **dense, **dropout)
        loss, terms = loss_fn(pred, scene, y)
        optim.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        ok = torch.isfinite(pred).all() if abort_on_nan else None
        with torch.no_grad():
            perc = percentage_errors(pred, y, targets)
            vec = torch.stack([loss.float()] + [terms[n].float() for n in sorted(terms)]
                              + [perc[n].float() for n in sorted(perc)])
            if group is not None:
                vec, ok = average_step(list(model.parameters()), vec, ok, group, grad_divisor)
        optim.update(ok)
        if not metric_names:
            metric_names.extend(["loss"] + sorted(terms) + sorted(perc))
        return vec

    return step, metric_names


def load_training_state(model, optim: NoamAdamW, payload,
                        model_type: Optional[str] = None) -> None:
    """A checkpoint payload's parameters (and PONITA's calibration statistics)
    and AdamW state (with ``apply_if_finite``'s counters, where it has them)
    into ``model`` and ``optim``, the JAX package's or the port's;
    ``model_type`` names the family the payload must be of."""
    model.load_state_dict(params_from_jax(payload["params"], model_type))
    adam = opt_state_from_jax(payload["opt_state"], model_type)
    if adam is not None:
        count, mu, nu = adam
        names = [n for n, _ in model.named_parameters()]
        optim.set_state(count, [mu[n] for n in names], [nu[n] for n in names],
                        skip_counts_from_jax(payload["opt_state"]))


class Trainer:
    def __init__(
        self,
        model,
        dataset: GravityDatasetOtf,
        args,
        resolved_config=None,
        valid_dataset=None,
        device="cuda",
    ):
        self.args = args
        self.model = model
        self.dataset = dataset
        # the partition="valid" stream; None falls back to the training stream
        self.valid_dataset = valid_dataset
        self.device = torch.device(device)
        self.targets = args.target.split("+")
        self.num_neighbors = args.num_neighbors or (args.num_atoms - 1)
        self.dtype = resolve_dtype(getattr(args, "precision_mode", "single"))
        self._refuse_what_is_not_ported()
        # always set: the flags are process-global, so an earlier Trainer in
        # this process must not leak its precision into this one
        set_matmul_precision(getattr(args, "matmul_precision", None))
        self.world = torch.distributed.get_world_size() if _group_up() else 1
        self.writes = self.world == 1 or torch.distributed.get_rank() == 0
        self.mesh = self._data_parallel_mesh()
        # the dataset serves this rank's rows itself, or the trainer takes them
        self._rows = None
        if self.mesh is not None:
            if hasattr(dataset, "shard"):
                dataset.shard(self.mesh)
            else:
                self._rows = self.mesh

        # the JAX trainer draws one batch to initialise its parameters, and
        # calibrates PONITA's on it; this draw keeps the frame order (and an
        # offline dataset's numpy stream) the same.  A batch of three items
        # carries its mask: the run's steps read their masks from the data
        batch0 = self._next_batch()
        self._data_masks = len(batch0) == 3
        if args.model_type == "ponita":
            scene0 = self._whole_batch(batch0[0]).astype(self.dtype)
            mask0 = (self._whole_batch(batch0[2]) if self._data_masks
                     else G.knn_mask(scene0.pos, self.num_neighbors))
            calibrate_params(model, scene0, mask0)
        del batch0
        # the JAX trainer's count: every leaf of its params tree, PONITA's
        # calibration statistics (3 a layer) included
        self.n_params = count_params(model)
        self.optim = create_optimizer(
            model.parameters(),
            learning_rate=args.learning_rate,
            model_size=model.get_model_size(),
            factor=args.learning_rate_factor,
            warmup=args.learning_rate_warmup_steps,
            clip_value=args.clip_gradients_value,
            clip_norm=args.clip_gradients_norm,
            discard_nan_gradients=args.discard_nan_gradients,
        )
        self.loss_fn = build_loss_fn(args)
        # the dropout masks' stream (the JAX trainer's PRNGKey(seed)); a rank's own
        seed = args.seed if getattr(args, "seed", None) is not None else 0
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed + (torch.distributed.get_rank() if self.mesh else 0))
        self.step_count = 0  # counts finished epochs
        self.best_metrics: Dict[str, float] = {}

        ts = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        suffix = "" if args.run_name is None else f"__{args.run_name}"
        self.save_dir_path = os.path.join("runs", args.model_type, f"{ts}{suffix}")
        if self.world > 1:  # the first rank's, which alone writes there
            self.save_dir_path = pmesh.broadcast_object(self.save_dir_path)
        if self.writes:
            os.makedirs(self.save_dir_path, exist_ok=True)
            self.logger = MetricsLogger(self.save_dir_path)
            if resolved_config is not None:
                save_config(resolved_config, self.save_dir_path)
            self._save_run_artifacts()
        else:
            self.logger = _NoLogger()
        if args.model_path:
            self.load_model_from_checkpoint(args.model_path)
        if self.mesh is not None:  # every rank starts from the first rank's parameters
            pmesh.replicate(list(model.state_dict().values()))

        step_args = (model, self.optim, self.loss_fn, self.targets, self.num_neighbors)
        step_kw = dict(abort_on_nan=getattr(args, "abort_on_nan_activations", False),
                       generator=self.generator)
        if self.mesh is not None:
            self._train_step, self._metric_names = make_sharded_train_step(
                *step_args, mesh=self.mesh, dtype=self.dtype, **step_kw)
        else:
            self._train_step, self._metric_names = make_train_step(*step_args, self.dtype,
                                                                   **step_kw)

    def _data_parallel_mesh(self):
        """The ``(sim, body=1)`` mesh of a data-parallel run, or None: data
        parallel when ``data_parallel`` is on, a group of K > 1 ranks is up and
        the batch divides by K; a line says which."""
        if self.world == 1:
            return None
        a = self.args
        backend = torch.distributed.get_backend()
        if getattr(a, "data_parallel", True) and a.batch_size % self.world == 0:
            print(f"Data-parallel over {self.world} ranks (sim axis, {backend})")
            return pmesh.make_mesh(self.world)
        why = ("data_parallel is off" if not getattr(a, "data_parallel", True)
               else f"batch {a.batch_size} does not divide by {self.world}")
        print(f"Not data-parallel ({why}): each of the {self.world} ranks ({backend}) trains "
              "the whole batch; the first rank writes")
        return None

    def _next_batch(self):
        """The next training batch: this rank's rows of it in a data-parallel run."""
        batch = self.dataset.get_batch()
        if self._rows is None:
            return batch
        return (shard_scene(batch[0], self._rows),
                *(pmesh.local_rows(x, self._rows) for x in batch[1:]))

    def _whole_batch(self, x):
        """A tensor or scene of this rank's rows gathered back to the whole batch."""
        if self.mesh is None:
            return x
        group = pmesh.axis_group(self.mesh, pmesh.SIM_AXIS)
        if isinstance(x, Scene):
            return Scene(*(None if t is None else pmesh.all_gather_rows(t, group)
                           for t in (x.pos, x.vel, x.force, x.mass, x.charge)))
        return pmesh.all_gather_rows(x, group)

    def _refuse_what_is_not_ported(self) -> None:
        a = self.args
        on_card = _build.wants_kernel(torch.empty(0, device=self.device))
        if (on_card and self.dtype == torch.float64 and has_edge_stage(self.model)
                and self.model.edge_impl != "dense"):
            raise NotImplementedError(
                f"precision_mode {a.precision_mode!r} on the card: the edge kernels K1 and K3 "
                "compute float32 (or bf16 operands), not float64, ROADMAP.md section 3; "
                "configure the model with --model.edge_impl dense")

    # ------------------------------------------------------------------ io

    def _save_run_artifacts(self):
        write_run_files(self.save_dir_path, self.args, self.model, self.dataset)

    def save_model(self, filename: str = "model.ckpt", final: bool = False):
        if not self.writes:  # only the first rank writes
            return os.path.join(self.save_dir_path, filename)
        names = [n for n, _ in self.model.named_parameters()]
        state = self.model.state_dict()

        def moments(ts):
            # optax keeps moments for every leaf of the tree: those of a leaf
            # that is no parameter (PONITA's calibration) stay zero
            return params_to_jax({**{k: torch.zeros_like(v) for k, v in state.items()},
                                  **dict(zip(names, ts))})

        exp_avg, exp_avg_sq = self.optim.moments()
        path = save_checkpoint(
            self.save_dir_path,
            params_to_jax(state),
            optax_opt_state(self.optim, moments(exp_avg), moments(exp_avg_sq)),
            self.step_count,
            self.best_metrics,
            filename=filename,
            backend=getattr(self.args, "checkpoint_backend", "pickle"),
        )
        if final:
            print(f"To continue training: --trainer.model_path {path} "
                  f"--config {os.path.join(self.save_dir_path, 'config.yaml')}")
        return path

    def _model_restoring_links(self, model_path: str) -> None:
        """Cross-link the run dirs on resume: ``<new>/restored_from/<old>`` and
        ``<old>/restoring/<new>`` (best effort)."""
        try:
            restored_dir = os.path.abspath(os.path.dirname(model_path))
            name = os.path.basename(os.path.normpath(restored_dir))
            link1 = os.path.join(self.save_dir_path, "restored_from", name)
            os.makedirs(os.path.dirname(link1), exist_ok=True)
            if not os.path.exists(link1):
                os.symlink(restored_dir, link1, target_is_directory=True)
            link2 = os.path.join(restored_dir, "restoring", os.path.basename(self.save_dir_path))
            os.makedirs(os.path.dirname(link2), exist_ok=True)
            if not os.path.exists(link2):
                os.symlink(os.path.abspath(self.save_dir_path), link2, target_is_directory=True)
        except OSError:
            pass

    def load_model_from_checkpoint(self, path: str):
        """Parameters, AdamW's count and moments (and with the count the Noam
        schedule), the epoch count and best metrics of a checkpoint, the JAX
        package's or the port's."""
        if self.writes:
            self._model_restoring_links(path)
        ckpt = load_checkpoint(path)
        load_training_state(self.model, self.optim, ckpt, self.args.model_type)
        self.step_count = ckpt.get("step_count", 0)
        self.best_metrics = ckpt.get("best_metrics", {})
        print(f"Loaded model and optimizer state from {path}")

    # ---------------------------------------------------------------- train

    def log_layer_stats(self, scene: Scene, mask: Optional[torch.Tensor] = None
                        ) -> Dict[str, float]:
        """Append the model's per-layer statistics on ``scene`` (on its
        training graph: ``mask``, the kNN mask where None) to
        ``layer_stats.jsonl``; one fetch."""
        if mask is None:
            mask = G.knn_mask(scene.pos, self.num_neighbors)
        stats = layer_stats.capture(self.model, scene, mask)
        record = layer_stats.record(self.step_count, stats)
        if not self.writes:
            return record
        with open(os.path.join(self.save_dir_path, "layer_stats.jsonl"), "a") as f:
            f.write(json.dumps(record) + "\n")
        return record

    def train_one_epoch(self) -> Dict[str, float]:
        n_steps = self.args.steps_per_epoch
        t_epoch = time.time()
        examples = 0
        stats_every = getattr(self.args, "debug_layer_stats_every", None)
        vecs = []  # per-step metric vectors, on the device until the epoch ends
        for step_i in range(n_steps):
            batch = self._next_batch()  # (scene, y), or (scene, y, mask)
            scene = batch[0]
            if stats_every and step_i % int(stats_every) == 0:
                self.log_layer_stats(scene.astype(self.dtype), *batch[2:])
            vecs.append(self._train_step(*batch))
            examples += scene.pos.shape[0] * (1 if self.mesh is None else self.world)
        arr = torch.stack(vecs).cpu().numpy()  # the epoch's one fetch
        dt = time.time() - t_epoch
        epoch_means = np.nanmean(arr, axis=0)
        log = {f"train/{k}": float(v) for k, v in zip(self._metric_names, epoch_means)}
        log["train/step"] = self.step_count
        log["train/steps_per_sec"] = n_steps / dt
        log["train/examples_per_sec"] = examples / dt
        self.logger.log(log)
        msg = " | ".join(f"{k.split('/')[-1]}: {v:.5f}" for k, v in log.items())
        print(f"Epoch {self.step_count} | {msg}")
        return log

    def _start_profile(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        return prof

    def _stop_profile(self, prof) -> None:
        """Stop a running trace and write it to ``<run>/profile/trace.json``."""
        if prof is None:
            return
        prof.stop()
        if not self.writes:
            return
        out = os.path.join(self.save_dir_path, "profile")
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, "trace.json"))

    def train(self):
        start = time.time()
        train_steps = self.args.train_steps
        profile_epochs = getattr(self.args, "profile_epochs", None)
        prof = self._start_profile() if profile_epochs else None
        try:
            while train_steps is None or self.step_count < train_steps:
                self.train_one_epoch()
                self.step_count += 1
                if prof is not None and self.step_count == profile_epochs:
                    self._stop_profile(prof)
                    prof = None
                if self.step_count % self.args.save_model_every == 0:
                    self.save_model()
                if self.step_count % self.args.test_macros_every == 0:
                    try:
                        self.run_self_feed_eval()
                    except Exception as e:  # an evaluation failure does not stop training
                        print(f"Couldn't run self-feed. Reason: {e}")
                        traceback.print_exc()
                if (getattr(self.args, "do_validation", False)
                        and self.step_count % getattr(self.args, "validation_frequency", 1) == 0):
                    self.validate_one_epoch()
        except KeyboardInterrupt:
            print("Training interrupted. Saving model...")
            self._stop_profile(prof)
            self.save_model(final=True)
            return
        except Exception as e:
            self._stop_profile(prof)
            self.save_model(final=True)
            self.logger.alert("Training crashed", f"{self.args.model_type}: {e}")
            raise
        self._stop_profile(prof)
        self.save_model(final=True)
        print(f"Training for {self.step_count} steps took {time.time() - start:.2f} seconds")

    # ------------------------------------------------------------ validation

    @torch.no_grad()
    def validate_one_epoch(self, num_batches: int = 10) -> Dict[str, float]:
        """Loss and percentage errors over fresh batches of the valid stream
        (an offline run's on the valid split's own masks); saves
        ``model_best_valid_loss.ckpt`` on improvement."""
        vds = self.valid_dataset if self.valid_dataset is not None else self.dataset
        self.model.eval()
        results = []
        for _ in range(num_batches):
            batch = vds.get_batch()
            scene, y = batch[0].astype(self.dtype), batch[1].to(self.dtype)
            mask = batch[2] if self._data_masks else G.knn_mask(scene.pos, self.num_neighbors)
            pred = self.model(scene, mask)
            total, terms = self.loss_fn(pred, scene, y)
            results.append((total, {**terms, **percentage_errors(pred, y, self.targets)}))
        # one device-to-host fetch for the whole epoch, in float64: the JAX
        # trainer reads each value in its own dtype (float64 in a double run)
        keys = list(results[0][1])
        arr = torch.stack([torch.stack([t] + [n[k] for k in keys]).double()
                           for t, n in results]).cpu().numpy()
        means: Dict[str, RunningMean] = {}
        for row in arr:
            for name, v in zip(["loss"] + keys, row):
                means.setdefault(name, RunningMean()).update(float(v))
        log = {f"valid/{k}": m.compute() for k, m in means.items()}
        log["valid/step"] = self.step_count - 1
        self.logger.log(log)
        if log["valid/loss"] < self.best_metrics.get("valid_loss", float("inf")):
            self.best_metrics["valid_loss"] = log["valid/loss"]
            self.save_model(filename="model_best_valid_loss.ckpt")
        if self.world > 1:  # every rank keeps the first rank's decisions
            self.best_metrics = pmesh.broadcast_object(self.best_metrics)
        return log

    # ------------------------------------------------------------- self-feed

    def run_self_feed_eval(self) -> int:
        """Rollout against fresh GT, macro KS and energy KS of the current
        parameters; writes the artifacts into ``checkpoints/<epoch>``."""
        print(f"Running self feed (epoch {self.step_count - 1})")
        save_dir = os.path.join(self.save_dir_path, "checkpoints", str(self.step_count))
        if getattr(self.args, "save_checkpoint_params", False) and self.writes:
            os.makedirs(save_dir, exist_ok=True)
            self.save_model(filename=os.path.join("checkpoints", str(self.step_count), "model.ckpt"))
        if not hasattr(self.dataset, "get_ground_truth_trajectories"):
            raise ValueError(
                f"self-feed needs ground-truth trajectories, which the "
                f"{type(self.dataset).__name__} ({self.args.dataset_name!r}) has not: an "
                "offline run sets test_macros_every past its epochs")
        with matmul_precision(getattr(self.args, "self_feed_matmul_precision", None)):
            loc_gt, vel_gt, loc_pred, vel_pred, survived = run_self_feed(
                self.model,
                self.dataset,
                num_steps=self.args.self_feed_limit_steps,
                num_neighbors=None,  # the rollout is fully connected
                train_mode=getattr(self.args, "self_feed_train_mode", True),
                rng=self.step_count,
                mesh=self.mesh,  # the sims sharded in a data-parallel run
            )
        if self.world == 1:
            return self._score_self_feed(save_dir, loc_gt, vel_gt, loc_pred, vel_pred, survived)
        # the first rank scores; every rank keeps its outcome (or its failure)
        outcome = None
        if self.writes:
            try:
                outcome = self._score_self_feed(save_dir, loc_gt, vel_gt, loc_pred, vel_pred,
                                                survived)
            except Exception as e:  # handed to every rank, raised below on each
                traceback.print_exc()
                outcome = e
        outcome, self.best_metrics = pmesh.broadcast_object((outcome, self.best_metrics))
        if isinstance(outcome, Exception):
            raise RuntimeError(f"scoring the self-feed failed on the first rank: {outcome!r}")
        return outcome

    def _score_self_feed(self, save_dir, loc_gt, vel_gt, loc_pred, vel_pred, survived) -> int:
        """Macro and energy KS of a rollout, its artifacts in ``save_dir``, the
        best-checkpoint decision; returns ``survived``."""
        per_macro, macro_combined, _, _ = artifacts.evaluate_rollout(
            save_dir,
            loc_gt,
            vel_gt,
            loc_pred,
            vel_pred,
            save_trajectory_npys=self.args.save_trajectory_npys,
            plot=self.args.plot_macros,
            extended=self.args.plot_macros,
            interaction_strength=self.dataset.interaction_strength,
            softening=self.dataset.softening,
        )

        G_ = self.dataset.interaction_strength
        soft = self.dataset.softening
        energies = {
            "simulation": energy_series(loc_gt, vel_gt, G_, soft),
            "self_feed": energy_series(loc_pred, vel_pred, G_, soft),
        }
        pvals = {
            f"energy_{k}": ks_p(energies["simulation"][k], energies["self_feed"][k])
            for k in ("total", "potential", "kinetic")
        }
        energy_combined = fisher_combine(list(pvals.values()))
        artifacts.write_energy_metrics_json(save_dir, energies, pvals, energy_combined)

        # steps within the energy-ratio band: the LAST in-band index, as the
        # reference counts it (a rollout that leaves and re-enters counts to the re-entry)
        sim_total = np.asarray(energies["simulation"]["total"]).reshape(-1)
        sf_total = np.asarray(energies["self_feed"]["total"]).reshape(-1)
        m = min(len(sim_total), len(sf_total))
        ratio = np.abs(sim_total[:m] / (sf_total[:m] + 1e-12))
        steps_metric = {}
        for t in ENERGY_ERROR_THRESHOLDS:
            ok = np.where((1.0 / t < ratio) & (ratio < t))[0]
            steps_metric[t] = int(ok[-1] + 1) if ok.size else 0

        primary = ENERGY_ERROR_THRESHOLDS[0]
        if steps_metric[primary] >= self.best_metrics.get("self_feed_steps", 0):
            self.best_metrics["self_feed_steps"] = steps_metric[primary]
            self.save_model(filename="model_best_self_feed.ckpt")

        payload = {
            "self_feed/steps_survived": int(survived),
            "self_feed/energy_steps_within_threshold": steps_metric[primary],
            "self_feed/step": self.step_count - 1,
        }

        def _log_p(prefix: str, val: float):
            if val != val:  # NaN means no data (no event in a short rollout): skip it
                return
            safe = max(float(val), 1e-300) if val > 0.0 else 1e-300
            payload[prefix] = safe
            payload[f"{prefix}_log10"] = float(np.log10(safe))
            payload[f"{prefix}_neglog10"] = float(-np.log10(safe))

        for key, val in pvals.items():
            _log_p(f"self_feed/ks_{key}", val)
        _log_p("self_feed/ks_combined", energy_combined)
        for key, val in per_macro.items():
            _log_p(f"self_feed/ks_macro_{key}", val)
        _log_p("self_feed/ks_macros_combined", macro_combined)
        _log_p(
            "self_feed/ks_all_combined",
            # energy and the reference's macro set, without the stuck_cluster_size extension
            fisher_combine(list(pvals.values())
                           + [v for k, v in per_macro.items() if k != "stuck_cluster_size"]),
        )
        self.logger.log(payload)
        print(f"Self feed: survived={survived} "
              f"macro_combined_p={macro_combined:.3e} energy_combined_p={energy_combined:.3e}")
        return int(survived)


def _group_up() -> bool:
    return torch.distributed.is_available() and torch.distributed.is_initialized()


class _NoLogger:
    """The logger of a rank that does not write."""

    def log(self, payload) -> None:
        pass

    def alert(self, title: str, text: str) -> None:
        pass


def create_trainer_from_args(args, resolved_config=None, device="cuda") -> Trainer:
    """The model, the dataloader ``args.dataloader_type`` names (and a valid
    stream when ``do_validation`` is on) and the trainer, on ``device``."""
    from ..data.dataloaders import create_dataloader

    model = create_model(args.model_type, device=device, **args.model_kwargs)
    dataset = create_dataloader(args, partition="train", device=device).dataset
    valid_dataset = (
        create_dataloader(args, partition="valid", device=device).dataset
        if getattr(args, "do_validation", False)
        else None
    )
    return Trainer(model, dataset, args, resolved_config=resolved_config,
                   valid_dataset=valid_dataset, device=device)
