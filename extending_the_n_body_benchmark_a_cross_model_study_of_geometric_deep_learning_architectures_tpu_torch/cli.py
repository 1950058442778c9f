"""Command-line entry point of the port::

    python -m extending_the_n_body_benchmark_a_cross_model_study_of_geometric_deep_learning_architectures_tpu_torch.cli \\
        train [--device cpu] [--config PATH] [--section.key value ...]

``train`` is the JAX package's ``train_main`` (its ``train.py``): the same
config and dot-overrides, on the card unless ``--device`` names another
device.  The JAX package's other mains (self-feed, validate, ks-test, hpo) are
not ported yet (ROADMAP.md, queue 1 item 5).
"""

from __future__ import annotations

import argparse
import random
import sys

import numpy as np
import torch


def set_seed(seed) -> None:
    """Seed Python's, NumPy's and torch's generators (nothing for None)."""
    if seed is None:
        return
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def train_main(argv=None):
    from .train.trainer import create_trainer_from_args
    from .utils.config import parse_args

    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default="cuda")
    known, rest = p.parse_known_args(argv)
    args, resolved = parse_args(rest)
    set_seed(getattr(args, "seed", None))
    trainer = create_trainer_from_args(args, resolved_config=resolved, device=known.device)
    print(f"Training {args.model_type} | params: {trainer.n_params:,} | "
          f"run dir: {trainer.save_dir_path}")
    trainer.train()
    return trainer


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] != "train":
        raise SystemExit("usage: python -m <package>.cli train [--device cpu] [--config PATH] "
                         "[--section.key value ...]; the other mains are not ported yet "
                         "(ROADMAP.md, queue 1 item 5)")
    train_main(argv[1:])


if __name__ == "__main__":
    main()
