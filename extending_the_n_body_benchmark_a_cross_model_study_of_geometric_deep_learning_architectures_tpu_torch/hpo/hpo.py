"""HPO: TPE search over model and trainer knobs with parameter-budget
matching.  Counterpart of the JAX package's ``hpo/hpo.py`` (its own copy of
the self-contained TPE sampler, median pruner and JSONL trial store).

* search spaces per model family: lr log-uniform 0.05..2.0, categorical
  widths / layers / heads;
* budget modes ``param_small`` (1.8M) and ``param_medium`` (10M) within 7 %,
  by bisection on the width knob with 16-multiple (head-divisible)
  quantization; ``time_matched`` bounds every trial by ``trial_minutes`` and
  matches no budget; ``free`` does neither;
* objective: log(Fisher-combined KS p) over the last checkpoints (best,
  mean or median);
* atomic JSONL trial log, resumable.

Parameters are counted on the ``meta`` device (no memory, no
initialisation), where the JAX package uses ``jax.eval_shape``.  The default
objective trains through the port's trainer on ``device`` (the card unless
the caller asks for the CPU).  Only families the port's ``models`` builds
can be counted or trained; any other raises ``NotImplementedError``, and no
study falls back to another family.

    python -m <package>.cli hpo --model_type egnn_mc --mode param_small ...
"""

from __future__ import annotations

import copy
import json
import math
import os
import random
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

PARAM_TOLERANCE = 0.07
PARAM_TARGETS = {"param_small": 1_800_000, "param_medium": 10_000_000}


# ----------------------------------------------------------------- sampler


class TPESampler:
    """Minimal TPE: split past trials at the gamma-quantile, model good/bad
    densities per dimension with kernel estimates, propose the candidate
    maximising the density ratio."""

    def __init__(self, space: Dict[str, Tuple], seed: int = 0, gamma: float = 0.25,
                 n_candidates: int = 24, n_startup: int = 8):
        self.space = space  # name -> ("float_log", lo, hi) | ("cat", choices)
        self.rng = random.Random(seed)
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.n_startup = n_startup

    def _random_point(self) -> Dict[str, Any]:
        out = {}
        for name, spec in self.space.items():
            if spec[0] == "float_log":
                lo, hi = spec[1], spec[2]
                out[name] = math.exp(self.rng.uniform(math.log(lo), math.log(hi)))
            else:
                out[name] = self.rng.choice(list(spec[1]))
        return out

    def propose(self, history: List[Dict[str, Any]]) -> Dict[str, Any]:
        done = [h for h in history if h.get("value") is not None]
        if len(done) < self.n_startup:
            return self._random_point()
        done = sorted(done, key=lambda h: -h["value"])  # maximize
        n_good = max(1, int(len(done) * self.gamma))
        good, bad = done[:n_good], done[n_good:]

        def score(point):
            s = 0.0
            for name, spec in self.space.items():
                if spec[0] == "float_log":
                    lv = math.log(point[name])
                    bw = max((math.log(spec[2]) - math.log(spec[1])) / 6.0, 1e-3)

                    def dens(group):
                        if not group:
                            return 1e-12
                        vals = [math.log(h["params"][name]) for h in group]
                        return sum(
                            math.exp(-0.5 * ((lv - v) / bw) ** 2) for v in vals
                        ) / len(vals) + 1e-12

                    s += math.log(dens(good) / dens(bad))
                else:
                    def freq(group):
                        if not group:
                            return 1.0 / len(spec[1])
                        c = sum(1 for h in group if h["params"][name] == point[name])
                        return (c + 1.0) / (len(group) + len(spec[1]))

                    s += math.log(freq(good) / freq(bad))
            return s

        cands = [self._random_point() for _ in range(self.n_candidates)]
        # also mutate around good points (actually perturbed — an exact copy
        # would maximize the density ratio and make the sampler re-run an
        # already-evaluated configuration verbatim)
        for h in good[: self.n_candidates // 4]:
            p = dict(h["params"])
            for name, spec in self.space.items():
                if spec[0] == "float_log":
                    lo, hi = spec[1], spec[2]
                    bw = (math.log(hi) - math.log(lo)) / 12.0
                    lv = math.log(p[name]) + self.rng.gauss(0.0, bw)
                    p[name] = math.exp(min(max(lv, math.log(lo)), math.log(hi)))
                elif self.rng.random() < 0.2:
                    p[name] = self.rng.choice(list(spec[1]))
            cands.append(p)
        return max(cands, key=score)


# ------------------------------------------------------------ pruning


class PrunedTrial(Exception):
    """Raised inside an objective when the pruner vetoes continuation."""


class MedianPruner:
    """``optuna.pruners.MedianPruner`` semantics (reference ``hpo.py:675``).

    A trial is pruned at step ``s`` when its intermediate value is strictly
    below the median of the intermediate values previously reported at the
    same step.  Note the reference *instantiates* this pruner but its
    objective never calls ``trial.report``, so pruning is inert there; here
    reporting is wired through :func:`run_study` (opt-in via ``pruner=``).
    """

    def __init__(self, n_startup_trials: int = 5, n_warmup_steps: int = 0):
        self.n_startup_trials = n_startup_trials
        self.n_warmup_steps = n_warmup_steps
        self._trials: List[Dict[int, float]] = []

    def register(self, intermediates: Dict[int, float]) -> None:
        """Record a finished (done or pruned) trial's intermediate values."""
        if intermediates:
            self._trials.append({int(k): float(v) for k, v in intermediates.items()})

    def should_prune(self, step: int, value: float) -> bool:
        if len(self._trials) < self.n_startup_trials or step < self.n_warmup_steps:
            return False
        at_step = [t[step] for t in self._trials if step in t]
        if not at_step:
            return False
        return value < float(np.median(at_step))


# ------------------------------------------------------------ search spaces


def search_space(model_type: str) -> Dict[str, Tuple]:
    """Per-model spaces (``hpo.py:87-169``)."""
    space: Dict[str, Tuple] = {"lr": ("float_log", 0.05, 2.0)}
    if model_type == "ponita":
        space["hidden_features"] = ("cat", [112, 128, 160, 192])
        space["num_layers"] = ("cat", [5, 6, 8, 10])
    elif model_type == "segnn":
        space["hidden_features"] = ("cat", [48, 64, 96, 128])
        space["num_layers"] = ("cat", [5, 6, 8, 10])
        space["lmax_h"] = ("cat", [1, 2])
    elif model_type == "equiformer_v2":
        space["num_layers"] = ("cat", [6, 8, 10])
        space["num_heads"] = ("cat", [4, 8])
        space["channel_base"] = ("cat", [112, 128, 160, 192])
    elif model_type == "cgenn":
        space["hidden_features"] = ("cat", [160, 192, 224, 256])
        space["num_layers"] = ("cat", [5, 6, 8, 10])
    elif model_type == "graph_transformer":
        space["hidden_features"] = ("cat", [176, 192, 224, 256])
        space["num_layers"] = ("cat", [6, 8, 10])
        space["num_heads"] = ("cat", [4, 8])
    elif model_type == "painn":
        space["hidden_features"] = ("cat", [128, 160, 192, 224])
        space["num_layers"] = ("cat", [4, 5, 6, 8])
    elif model_type == "egnn_mc":
        space["hidden_node_dim"] = ("cat", [96, 128, 160, 192])
        space["num_layers"] = ("cat", [4, 5, 6, 8])
    return space


_WIDTH_KEY = {
    "equiformer_v2": "sphere_channels",
    "egnn_mc": "hidden_node_dim",
}


def _require_family(model_type: str) -> None:
    from ..models import MODEL_REGISTRY

    if model_type not in MODEL_REGISTRY:
        raise NotImplementedError(
            f"model family {model_type!r} is not ported yet (ROADMAP.md, queue 1 item 6); "
            f"the port builds {sorted(MODEL_REGISTRY)}")


def _count_params(model_type: str, model_kwargs: Dict[str, Any], num_atoms: int) -> int:
    """The parameter count of ``model_type`` built with ``model_kwargs`` on the
    meta device, as the JAX package counts it: every leaf of the params tree,
    PONITA's calibration statistics (3 a layer) included.  ``num_atoms`` is
    kept for the JAX signature: no family's parameters depend on N."""
    from ..models import count_params, create_model

    _require_family(model_type)
    with torch.device("meta"):
        model = create_model(model_type, device="meta", **model_kwargs)
    return count_params(model)


def _quantize_width(model_type: str, width: int, heads: int = 1) -> int:
    base = 16
    if model_type in ("equiformer_v2", "graph_transformer") and heads:
        width = ((width + heads - 1) // heads) * heads
    return max(base, ((width + base // 2) // base) * base)


def adjust_width_to_target(
    model_type: str,
    model_kwargs: Dict[str, Any],
    target: int,
    num_atoms: int = 5,
    tolerance: float = PARAM_TOLERANCE,
) -> Tuple[Dict[str, Any], int]:
    """Bisection on the primary width knob until the param count is within
    tolerance of the target, counting on the meta device.  Returns (kwargs,
    param_count).  A family the port cannot build raises before the width
    knob is looked for, so a study of it raises rather than failing a trial."""
    _require_family(model_type)
    key = _WIDTH_KEY.get(model_type, "hidden_features")
    if key not in model_kwargs:
        raise ValueError(
            f"param-budget mode needs a width knob to bisect, but "
            f"{model_type!r} sampled no {key!r} (its search space has no "
            f"width dimension) — pass one via the base config's models "
            f"section or use mode='free'/'time_matched'"
        )
    heads = model_kwargs.get("num_heads", 1) or 1
    kwargs = dict(model_kwargs)

    def sync(kw):
        # equiformer_v2 scales three channel knobs in lockstep
        # (trial_to_overrides ties them too); keep them consistent on every
        # width update, including the final non-converged one
        if model_type == "equiformer_v2":
            for k in ("sphere_channels", "attn_hidden_channels", "ffn_hidden_channels"):
                kw[k] = kw[key]
        return kw

    lo, hi = 16, 1536
    for _ in range(10):
        n = _count_params(model_type, sync(kwargs), num_atoms)
        if abs(n - target) / target <= tolerance:
            return kwargs, n
        if n > target:
            hi = kwargs[key]
        else:
            lo = kwargs[key]
        kwargs[key] = _quantize_width(model_type, (lo + hi) // 2, heads)
        if hi - lo <= 16:
            break
    n = _count_params(model_type, sync(kwargs), num_atoms)
    if abs(n - target) / target > tolerance:
        # the reference also proceeds with the non-converged width, recording
        # the actual param count (``hpo.py:609-617``) — warn but don't abort
        print(
            f"[hpo] width bisection for {model_type} stopped outside "
            f"tolerance: {n} params vs target {target} (±{tolerance:.0%}) "
            f"at {key}={kwargs[key]}"
        )
    return kwargs, n


# ---------------------------------------------------------------- objective


def trial_to_overrides(model_type: str, params: Dict[str, Any]) -> Tuple[Dict, Dict]:
    """Map sampled params to (model_kwargs, trainer_overrides)."""
    model_kwargs: Dict[str, Any] = {}
    trainer = {
        "learning_rate": params["lr"],
        "learning_rate_factor": 1.0,
        "learning_rate_warmup_steps": 2048,
    }
    for k, v in params.items():
        if k == "lr":
            continue
        if k == "channel_base":
            model_kwargs["sphere_channels"] = v
            model_kwargs["attn_hidden_channels"] = v
            model_kwargs["ffn_hidden_channels"] = v
        else:
            model_kwargs[k] = v
    return model_kwargs, trainer


def score_run(run_dir: str, last_k: int = 3, mode: str = "best") -> float:
    """log(combined KS p) aggregated over the last k checkpoints
    (``hpo.py:331-467``)."""
    from ..evaluation.ks_checkpoints import load_checkpoint_pvalues

    ckpt_root = os.path.join(run_dir, "checkpoints")
    if not os.path.isdir(ckpt_root):
        return math.log(1e-300)
    steps = sorted((d for d in os.listdir(ckpt_root) if d.isdigit()), key=int)
    vals = []
    for step in steps[-last_k:]:
        _, combined = load_checkpoint_pvalues(os.path.join(ckpt_root, step))
        if combined == combined:
            vals.append(math.log(max(combined, 1e-300)))
    if not vals:
        return math.log(1e-300)
    if mode == "best":
        return max(vals)
    if mode == "median":
        return float(np.median(vals))
    return float(np.mean(vals))


def _atomic_append(path: str, record: Dict) -> None:
    tmp = path + ".tmp"
    existing = ""
    if os.path.exists(path):
        with open(path) as f:
            existing = f.read()
    with open(tmp, "w") as f:
        f.write(existing + json.dumps(record) + "\n")
    os.replace(tmp, path)


def suggest_trial(model_type: str, history: List[Dict], seed: int = 0) -> Dict[str, Any]:
    sampler = TPESampler(search_space(model_type), seed=seed + len(history))
    return sampler.propose(history)


def run_study(
    model_type: str,
    trials: int = 10,
    mode: str = "free",  # free | param_small | param_medium | time_matched
    study_dir: str = "hpo_results",
    base_config: Optional[Dict] = None,
    train_epochs: int = 4,
    steps_per_epoch: int = 50,
    self_feed_limit_steps: int = 20,
    seed: int = 0,
    objective_fn=None,
    pruner: Optional[MedianPruner] = None,
    trial_minutes: Optional[float] = None,
    device="cuda",
) -> Dict:
    """Run (or resume) a study; returns the best trial record.

    ``objective_fn(model_kwargs, trainer_overrides) -> float`` can be
    injected (tests); the default trains via the real Trainer and scores the
    last checkpoints' combined KS p.  With ``pruner`` set, the objective may
    accept a third ``report(step, value)`` argument: calling it raises
    :class:`PrunedTrial` when the pruner vetoes continuation (the trial is
    recorded with status ``pruned`` and its partial value kept).

    ``mode="time_matched"`` is the reference's third mode
    (``hpo.py:476-480``): no parameter-budget matching — every trial instead
    gets the same wall-clock budget, ``trial_minutes`` (reference default
    40, ``--trial_minutes``).  As in the reference, ``trial_minutes`` also
    bounds trials of the other modes when set (``hpo.py:309,328``);
    ``train_epochs`` plays the reference's ``max_updates`` role.

    The default objective trains on ``device``; a family the port cannot build
    raises ``NotImplementedError`` before any trial.
    """
    import inspect

    from ..utils.config import flatten_args

    if objective_fn is None:
        _require_family(model_type)

    os.makedirs(study_dir, exist_ok=True)
    store = os.path.join(study_dir, f"{model_type}_{mode}_trials.jsonl")
    history: List[Dict] = []
    if os.path.exists(store):
        with open(store) as f:
            history = [json.loads(l) for l in f if l.strip()]
    if pruner is not None:  # resume: rebuild pruner state from the store
        for h in history:
            pruner.register(h.get("intermediates") or {})

    # per-trial runtime telemetry, the reference's ``steps_per_min`` /
    # ``peak_vram_mb`` trial fields (``hpo.py:435-462``) — filled by
    # default_objective, copied into the trial record by the study loop
    last_telemetry: Dict[str, float] = {}
    device_is_card = torch.device(device).type == "cuda"

    def default_objective(model_kwargs, trainer_overrides, report=None):
        from ..train.trainer import create_trainer_from_args

        # deep copy: the section dicts below are mutated per trial and must
        # not leak into the caller's base_config across trials
        cfg = copy.deepcopy(base_config) if base_config else {}
        cfg.setdefault("main", {})["model_type"] = model_type
        cfg["main"]["dataloader_type"] = f"{model_type}_nbody"
        # wholesale assignment is safe: the study loop already layered the
        # caller's models section under the sampled/adjusted kwargs
        cfg.setdefault("models", {})[model_type] = model_kwargs
        tr = cfg.setdefault("trainers", {}).setdefault("trainer_nbody", {})
        tr.update(trainer_overrides)
        eval_every = max(1, train_epochs // 2)
        tr.update(
            train_steps=train_epochs,
            steps_per_epoch=steps_per_epoch,
            test_macros_every=eval_every,
            save_model_every=eval_every,
            self_feed_limit_steps=self_feed_limit_steps,
            plot_macros=False,
            save_trajectory_npys=False,
        )
        args = flatten_args(cfg)
        if device_is_card:
            torch.cuda.reset_peak_memory_stats(device)
        trainer = create_trainer_from_args(args, device=device)
        t_obj = time.time()
        if report is None and trial_minutes is None:
            trainer.train()
        else:
            # incremental epochs so intermediate KS scores can be reported
            # and the wall-clock budget enforced (the reference's
            # run_short_training_and_score loop shape, hpo.py:307-329 —
            # time check at :328, with reporting actually wired up)
            t_start = time.time()
            last_eval = 0

            def _eval_and_report():
                nonlocal last_eval
                last_eval = trainer.step_count
                # keep-training crash resilience, matching Trainer.train()'s
                # own eval wrapper
                try:
                    trainer.run_self_feed_eval()
                    if report is not None:
                        report(trainer.step_count, score_run(trainer.save_dir_path))
                except PrunedTrial:
                    raise
                except Exception as e:
                    print(f"self-feed eval failed at {trainer.step_count}: {e!r}")

            try:
                while trainer.step_count < train_epochs:
                    trainer.train_one_epoch()
                    trainer.step_count += 1
                    if trainer.step_count % eval_every == 0:
                        trainer.save_model()  # save_model_every cadence
                        _eval_and_report()
                    if (
                        trial_minutes is not None
                        and (time.time() - t_start) / 60.0 >= trial_minutes
                    ):
                        break
                # a trial stopped by the wall-clock budget (or whose final
                # epoch missed the eval cadence) still needs a scored
                # checkpoint at its end state — otherwise short time_matched
                # budgets produce zero checkpoints and every trial floors at
                # log(1e-300), making the study's scores meaningless
                if last_eval < trainer.step_count:
                    _eval_and_report()
            except BaseException:
                # keep the partial checkpoint like Trainer.train()'s crash
                # path (covers PrunedTrial too)
                trainer.save_model(final=True)
                raise
            trainer.save_model(final=True)
        minutes = max((time.time() - t_obj) / 60.0, 1e-9)
        last_telemetry["steps_per_min"] = (
            trainer.step_count * steps_per_epoch / minutes
        )
        if device_is_card:  # the card's peak, the JAX package's key
            last_telemetry["peak_hbm_mb"] = torch.cuda.max_memory_allocated(device) / 2**20
        return score_run(trainer.save_dir_path)

    objective = objective_fn or default_objective
    takes_report = "report" in inspect.signature(objective).parameters

    while len(history) < trials:
        t0 = time.time()
        # cleared per trial, before the objective can fail: a trial that
        # crashes in config/trainer construction must not inherit the
        # previous trial's steps_per_min/peak_hbm_mb into its record
        last_telemetry.clear()
        params = suggest_trial(model_type, history, seed)
        model_kwargs, trainer_overrides = trial_to_overrides(model_type, params)
        # layer the sampled knobs over the caller's configured model section
        # so width bisection counts params for the SAME architecture the
        # trial will train (e.g. a base lmax_attr=2 must not silently revert
        # to the registry default)
        base_mk = dict(((base_config or {}).get("models") or {}).get(model_type) or {})
        model_kwargs = {**base_mk, **model_kwargs}
        record = {
            "number": len(history),
            "params": params,
            "model_kwargs": model_kwargs,
            "n_params": None,
            "status": "running",
            "value": None,
        }
        intermediates: Dict[int, float] = {}

        def report(step: int, value: float) -> None:
            intermediates[int(step)] = float(value)
            # best-so-far partial value (a late-pruned trial's record keeps
            # its best intermediate, not the pruning-triggering one)
            prev = record["value"]
            record["value"] = float(value) if prev is None else max(prev, float(value))
            if pruner is not None and pruner.should_prune(int(step), float(value)):
                raise PrunedTrial(f"step {step}: {value} below running median")

        try:
            # inside the try so a bisection failure (e.g. no width knob)
            # records a failed trial instead of crashing the whole study;
            # a family the port cannot build is no trial's failure and raises
            if mode in PARAM_TARGETS:
                model_kwargs, n_params = adjust_width_to_target(
                    model_type, model_kwargs, PARAM_TARGETS[mode]
                )
                record["model_kwargs"] = model_kwargs
                record["n_params"] = n_params
            else:
                # free/time_matched trials carry their param count too
                # (meta device, nothing allocated).  Best-effort: a kwargs set
                # or family the counter can't build (an injected objective's
                # synthetic keys) must not fail the trial itself
                try:
                    record["n_params"] = _count_params(model_type, model_kwargs, 5)
                except Exception:
                    pass
            call_args = (model_kwargs, trainer_overrides)
            if pruner is not None and takes_report:
                record["value"] = float(objective(*call_args, report=report))
            else:
                record["value"] = float(objective(*call_args))
            record["status"] = "done"
        except NotImplementedError:
            raise
        except PrunedTrial as e:
            record["status"] = "pruned"
            record["error"] = str(e)
        except Exception as e:  # crash resilience (hpo.py heartbeats)
            record["status"] = "failed"
            record["error"] = repr(e)
        if intermediates:
            record["intermediates"] = intermediates
        if pruner is not None:
            pruner.register(intermediates)
        record["seconds"] = time.time() - t0
        record.update(last_telemetry)
        history.append(record)
        _atomic_append(store, record)

    # pruned/failed trials keep their partial value for the record but
    # (like optuna) do not compete for best — a crashed trial's last
    # intermediate report is not a completed result
    done = [
        h
        for h in history
        if h.get("value") is not None and h.get("status", "done") == "done"
    ]
    best = max(done, key=lambda h: h["value"]) if done else None
    with open(os.path.join(study_dir, f"{model_type}_{mode}_summary.json"), "w") as f:
        json.dump({"best": best, "n_trials": len(history)}, f, indent=2)
    return best


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="HPO study")
    p.add_argument("--model_type", required=True)
    p.add_argument("--trials", type=int, default=10)
    p.add_argument("--mode", default="free",
                   choices=["free", "param_small", "param_medium", "time_matched"])
    p.add_argument("--trial_minutes", type=float, default=None,
                   help="wall-clock budget per trial (reference default 40; "
                        "required meaningfully by --mode time_matched)")
    p.add_argument("--study_dir", default="hpo_results")
    p.add_argument("--train_epochs", type=int, default=4)
    p.add_argument("--steps_per_epoch", type=int, default=50)
    p.add_argument("--self_feed_limit_steps", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--sim_length", type=int, default=None)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    base = {}
    dl = {k: v for k, v in
          {"batch_size": a.batch_size,
           "gravity_dataset": {"sim_length": a.sim_length} if a.sim_length else None}.items()
          if v is not None}
    if dl:
        base = {"dataloaders": {f"{a.model_type}_nbody": dl}}
    trial_minutes = a.trial_minutes
    if a.mode == "time_matched" and trial_minutes is None:
        trial_minutes = 40.0  # reference --trial_minutes default (hpo.py:480)
    best = run_study(
        a.model_type, trials=a.trials, mode=a.mode, study_dir=a.study_dir,
        base_config=base or None, train_epochs=a.train_epochs,
        steps_per_epoch=a.steps_per_epoch,
        self_feed_limit_steps=a.self_feed_limit_steps,
        trial_minutes=trial_minutes, device=a.device,
    )
    print("best trial:", json.dumps(best, indent=2))
    return best


if __name__ == "__main__":
    main()
