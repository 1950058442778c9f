"""Dataloader layer: owns the dataset, hands out dense ``(Scene, y)`` batches
and builds the model's neighbour mask.

Counterpart of the JAX package's ``data/dataloaders.py``, with its registry's
keys: the on-the-fly gravity loader of every family, and
``segnn_nbody_offline``, the offline charged-systems loader, whose dataset
(``data/offline_dataset.py``) hands the trainer its cutoff-rate masks with
each batch.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Type

import torch

from ..core import graph as G
from ..core.scene import Scene
from .gravity_otf import GravityDatasetOtf
from .offline_dataset import OfflineNBodyDataset


class NBodyDataLoader:
    """On-the-fly gravity dataloader on ``device``."""

    def __init__(self, args, partition: str = "train", device="cuda"):
        self.args = args
        self.partition = partition
        self.device = device
        self.dataset = self.create_dataset()
        n = self.dataset.num_nodes
        k = getattr(args, "num_neighbors", None)
        self.num_neighbors = k if (k and 0 < k < n) else n - 1

    def create_dataset(self) -> GravityDatasetOtf:
        a = self.args
        train = self.partition == "train"
        # a non-train partition is an independent stream: it neither reads nor
        # writes the sim cache (a shared cache would replay the training
        # trajectories) and, in a seeded run, draws from a disjoint seed
        seed = getattr(a, "data_seed", None)
        if not train and seed is not None:
            seed = seed + 7919
        return GravityDatasetOtf(
            dataset_name=a.dataset_name,
            target=a.target,
            batch_size=a.batch_size,
            sim_length=getattr(a, "sim_length", 10000),
            sample_freq=a.sample_freq,
            noise_var=getattr(a, "noise_var", 0.0),
            num_nodes=a.num_atoms,
            vel_norm=getattr(a, "vel_norm", 1e-16),
            interaction_strength=getattr(a, "interaction_strength", 2.0),
            dt=getattr(a, "dt", 0.01),
            softening=getattr(a, "softening", 0.2),
            double_precision=getattr(a, "double_precision", False),
            center_of_mass=getattr(a, "center_of_mass", False),
            use_cached=train
            and getattr(a, "use_cached", True)
            and getattr(a, "model_path", None) is None,
            cache_data=train and getattr(a, "cache_data", True),
            seed=seed,
            device=self.device,
        )

    def get_batch(self) -> Tuple[Scene, torch.Tensor]:
        return self.dataset.get_batch()

    def preprocess_batch(self, scene: Scene) -> torch.Tensor:
        """The model's input graph: the ``num_neighbors`` nearest bodies."""
        return G.knn_mask(scene.pos, self.num_neighbors)

    def postprocess_batch(self, predictions):
        return predictions

    def get_num_nodes(self) -> int:
        return self.dataset.num_nodes

    def get_ground_truth_trajectories(self, batch_size: Optional[int] = None):
        return self.dataset.get_ground_truth_trajectories(batch_size)


class OfflineSegnnDataLoader:
    """The offline charged-systems loader (files from ``data/offline_datagen.py``
    in ``data_directory``), on ``device``."""

    def __init__(self, args, partition: str = "train", device="cuda"):
        self.args = args
        self.dataset = OfflineNBodyDataset(
            dataset_name=args.dataset_name,
            data_dir=getattr(args, "data_directory", "datasets_offline/data"),
            partition=partition,
            max_samples=getattr(args, "max_samples", 10**8),
            frame_0=getattr(args, "frame_0", 30),
            frame_T=getattr(args, "frame_T", 40),
            cutoff_rate=getattr(args, "cutoff_rate", 0.0),
            target=args.target,
            batch_size=args.batch_size,
            # batch selection and the test split's rotations follow the run's data seed
            seed=getattr(args, "data_seed", None) or 0,
            device=device,
        )

    def get_batch(self) -> Tuple[Scene, torch.Tensor]:
        scene, y, _mask = self.dataset.get_batch()
        return scene, y

    def preprocess_batch(self, scene: Scene) -> torch.Tensor:
        """The cutoff-rate mask of ``scene`` itself (not of the last batch
        drawn), computed on the host as the dataset computes it."""
        mask = self.dataset.edge_mask(scene.pos.detach().cpu().numpy())
        return torch.from_numpy(mask).to(scene.pos.device)

    def postprocess_batch(self, predictions):
        return predictions

    def get_num_nodes(self) -> int:
        return self.dataset.num_nodes


DATALOADER_REGISTRY: Dict[str, Type] = {
    "egnn_mc_nbody": NBodyDataLoader,
    "painn_nbody": NBodyDataLoader,
    "graph_transformer_nbody": NBodyDataLoader,
    "ponita_nbody": NBodyDataLoader,
    "segnn_nbody": NBodyDataLoader,
    "seconv_nbody": NBodyDataLoader,
    "cgenn_nbody": NBodyDataLoader,
    "equiformer_v2_nbody": NBodyDataLoader,
    "gmn_nbody": NBodyDataLoader,
    "segnn_nbody_offline": OfflineSegnnDataLoader,
}


def create_dataloader(args, partition: str = "train", device="cuda"):
    """The dataloader that ``args.dataloader_type`` names (default
    ``{model_type}_nbody``), on ``device``."""
    name = getattr(args, "dataloader_type", None) or f"{args.model_type}_nbody"
    cls = DATALOADER_REGISTRY.get(name, NBodyDataLoader)
    return cls(args, partition=partition, device=device)
