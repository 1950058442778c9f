"""The offline charged-systems dataset: counterpart of the JAX package's
``data/offline_dataset.py``.

Loads the ``{loc,vel,edges,charges}_{split}_charged<cfg>.npy`` files (either
package's ``offline_datagen`` writes them), takes the ``(frame_0, frame_T)``
pair and hands out dense ``(Scene, y, mask)`` batches on ``device``:

* a cutoff-rate edge mask: each system keeps its ``(1 - cutoff_rate) N (N -
  1)`` smallest pairwise distances, a boolean ``[N, N]`` mask whose rows may
  have any degree, 0 included;
* random integer-degree rotations of the test split, one a system;
* targets ``pos_dt+vel`` (or ``pos+vel``, ``pos_dt+vel_dt``).

The host side is the JAX package's numpy code, step for step: the batch
selection and the rotations from ``np.random.default_rng(seed)``, the mask by
``np.argpartition``.  So the same files and seed give bitwise the same
batches, rotations and masks in both packages, ties at the cutoff included.
Only the finished batch moves to the device.
"""

from __future__ import annotations

import os
import pickle
from typing import Tuple

import numpy as np
from .. import _tf32  # noqa: F401  (TF32 off before torch is used)
import torch

from ..core.scene import Scene


def random_rotation_matrix(rng: np.random.Generator) -> np.ndarray:
    """Euler xyz rotation with integer-degree angles."""
    x, y, z = np.radians(rng.integers(0, 361, size=3).astype(np.float64))

    def rx(t):
        return np.array([[1, 0, 0], [0, np.cos(t), -np.sin(t)], [0, np.sin(t), np.cos(t)]])

    def ry(t):
        return np.array([[np.cos(t), 0, np.sin(t)], [0, 1, 0], [-np.sin(t), 0, np.cos(t)]])

    def rz(t):
        return np.array([[np.cos(t), -np.sin(t), 0], [np.sin(t), np.cos(t), 0], [0, 0, 1]])

    return rx(x) @ ry(y) @ rz(z)


class OfflineNBodyDataset:
    def __init__(
        self,
        dataset_name: str,
        data_dir: str,
        partition: str = "train",
        max_samples: int = 10**8,
        frame_0: int = 30,
        frame_T: int = 40,
        cutoff_rate: float = 0.0,
        target: str = "pos_dt+vel",
        batch_size: int = 64,
        seed: int = 0,
        device="cuda",
    ):
        self.dataset_name = dataset_name
        self.data_dir = data_dir
        self.partition = partition
        self.frame_0, self.frame_T = frame_0, frame_T
        self.cutoff_rate = cutoff_rate
        self.target = target
        self.batch_size = batch_size
        self.device = torch.device(device)
        self._rng = np.random.default_rng(seed)

        suffix = f"{partition}_charged{dataset_name}"
        loc = np.load(os.path.join(data_dir, f"loc_{suffix}.npy"))[:max_samples]
        vel = np.load(os.path.join(data_dir, f"vel_{suffix}.npy"))[:max_samples]
        charges = np.load(os.path.join(data_dir, f"charges_{suffix}.npy"))[:max_samples]
        cfg_path = os.path.join(data_dir, f"cfg_{suffix}.pkl")
        self.cfg = None
        if os.path.exists(cfg_path):
            with open(cfg_path, "rb") as f:
                self.cfg = pickle.load(f)

        loc_0 = loc[:, frame_0].astype(np.float32)
        loc_t = loc[:, frame_T].astype(np.float32)
        vel_0 = vel[:, frame_0].astype(np.float32)
        vel_t = vel[:, frame_T].astype(np.float32)

        if partition == "test":  # a rotation a system
            for i in range(loc_0.shape[0]):
                R = random_rotation_matrix(self._rng).astype(np.float32)
                loc_0[i] = loc_0[i] @ R
                loc_t[i] = loc_t[i] @ R
                vel_0[i] = vel_0[i] @ R
                vel_t[i] = vel_t[i] @ R

        self.loc_0, self.loc_t = loc_0, loc_t
        self.vel_0, self.vel_t = vel_0, vel_t
        self.charges = charges.astype(np.float32)
        self.num_nodes = loc_0.shape[1]

    def __len__(self) -> int:
        return self.loc_0.shape[0]

    def edge_mask(self, loc_0: np.ndarray) -> np.ndarray:
        """The global smallest-distance cutoff: bool ``[B, N, N]`` keeping
        ``(1 - cutoff_rate) N (N - 1)`` edges a system."""
        B, N, _ = loc_0.shape
        d = np.linalg.norm(loc_0[:, :, None] - loc_0[:, None, :], axis=-1)
        d = d + np.eye(N) * 1e18
        keep = int(N * (N - 1) * (1.0 - self.cutoff_rate))
        if keep <= 0:  # argpartition(kth=-1) would mis-partition
            return np.zeros((B, N, N), dtype=bool)
        flat = d.reshape(B, -1)
        idx = np.argpartition(flat, keep - 1, axis=1)[:, :keep]
        mask = np.zeros((B, N * N), dtype=bool)
        np.put_along_axis(mask, idx, True, axis=1)
        return mask.reshape(B, N, N)

    def _build_y(self, sel: np.ndarray) -> np.ndarray:
        pos_dt = self.loc_t[sel] - self.loc_0[sel]
        if self.target == "pos_dt+vel":
            return np.concatenate([pos_dt, self.vel_t[sel]], axis=-1)
        if self.target == "pos+vel":
            return np.concatenate([self.loc_t[sel], self.vel_t[sel]], axis=-1)
        if self.target == "pos_dt+vel_dt":
            return np.concatenate([pos_dt, self.vel_t[sel] - self.vel_0[sel]], axis=-1)
        raise ValueError(f"Wrong target {self.target}")

    def _batch(self, sel: np.ndarray) -> Tuple[Scene, torch.Tensor, torch.Tensor]:
        """The systems ``sel`` as ``(Scene, y, edge_mask)`` on the device:
        ``force`` zeros, ``mass`` ones, ``charge`` the systems' charges."""
        dev = self.device

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        shape = (len(sel), self.num_nodes)
        scene = Scene(pos=put(self.loc_0[sel]), vel=put(self.vel_0[sel]),
                      force=torch.zeros(shape + (3,), dtype=torch.float32, device=dev),
                      mass=torch.ones(shape + (1,), dtype=torch.float32, device=dev),
                      charge=put(self.charges[sel]))
        return scene, put(self._build_y(sel)), put(self.edge_mask(self.loc_0[sel]))

    def get_batch(self) -> Tuple[Scene, torch.Tensor, torch.Tensor]:
        """A random batch of systems: ``(Scene, y, edge_mask)``."""
        return self._batch(self._rng.integers(0, len(self), size=self.batch_size))

    def get_serializable_attributes(self) -> dict:
        return {
            "dataset_name": self.dataset_name,
            "data_dir": self.data_dir,
            "partition": self.partition,
            "max_samples": len(self),
            "frame_0": self.frame_0,
            "frame_T": self.frame_T,
            "cutoff_rate": self.cutoff_rate,
        }
