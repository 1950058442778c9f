"""On-the-fly gravity dataset: a queue of on-device trajectory batches with
frame-pair sampling for training, and fresh trajectories for evaluation.

Counterpart of the JAX package's ``data/gravity_otf.py``:

* A batch of simulations is one call of ``core.physics.sample_trajectory_batch``
  (on the card, one launch of the integrator K2-leapfrog where its shape rule
  says so) and stays on the device.
* Frame-pair sampling keeps the JAX package's semantics exactly: one unused
  frame index per draw, shared over the batch of sims, drawn without
  replacement by a ``random.Random(seed)``; when the pool is empty the next
  batch is loaded.  ``PREFETCH`` draws are gathered in one indexing op.
* The disk cache keeps the JAX package's layout: ``.npz`` files under
  ``<cache_dir>/<sha256 of the generation parameters>/``, written with an
  atomic claim-and-replace, read only by the training queue
  (``get_ground_truth_trajectories`` never reads it).
* ``get_serializable_attributes`` / ``from_metadata`` keep its metadata schema,
  so run-dir ``metadata.json`` files are interchangeable.

``shard(mesh)`` makes it a data-parallel rank's (the JAX trainer's sharded
batch, ``parallel.sharded``): it takes over the first rank's generator and
frame order, so every rank draws the same batches, and it integrates and
serves only this rank's sims of each training batch
(``parallel.sharded.sharded_datagen``: on the card bitwise the
single-process batch's rows); ``get_ground_truth_trajectories`` gathers the whole batch back, and
only the first rank writes the cache (the whole batch, gathered).

One difference: the JAX dataset generates its first training batch in the
constructor; this one at the first ``get_batch``, so a dataset that only
serves evaluation generates (and caches) nothing that it does not return.  The
frame order is the same either way.  Random trajectories come from a
``torch.Generator`` and differ from ``jax.random``'s for the same seed.
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import random
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.physics import GravityParams, sample_trajectory_batch
from ..core.scene import Scene
from ..core.targets import TARGETS
from ..parallel import mesh as pmesh
from ..parallel.sharded import sharded_datagen


class GravityDatasetOtf:
    """Queue of on-device trajectory batches with frame-pair sampling."""

    # frame pairs gathered per indexing op; the host keeps them in a FIFO
    PREFETCH = 16

    def __init__(
        self,
        dataset_name: str = "nbody_small",
        target: str = "pos_dt+vel",
        batch_size: int = 64,
        sim_length: int = 10000,
        sample_freq: int = 10,
        noise_var: float = 0.0,
        num_nodes: int = 5,
        vel_norm: float = 1e-16,
        interaction_strength: float = 2.0,
        dt: float = 0.01,
        softening: float = 0.2,
        double_precision: bool = False,
        center_of_mass: bool = False,
        lmax_attr: int = 1,
        use_cached: bool = False,
        cache_data: bool = True,
        cache_dir: str = "saved_simulations",
        seed: Optional[int] = None,
        device="cuda",
    ):
        if target not in TARGETS:
            raise ValueError(f"Wrong target {target}")
        self.dataset_name = dataset_name
        self.target = target
        self.batch_size = batch_size
        self.sample_freq = sample_freq
        self.sim_length = sim_length - (sim_length % sample_freq)
        self.noise_var = noise_var
        self.num_nodes = num_nodes
        self.vel_norm = vel_norm
        self.interaction_strength = interaction_strength
        self.dt = dt
        self.softening = softening
        self.double_precision = double_precision
        self.center_of_mass = center_of_mass
        self.lmax_attr = lmax_attr
        self.use_cached = use_cached
        self.cache_data = cache_data
        self.cache_dir = cache_dir
        self.cache_index = 0 if use_cached else -1
        self.dtype = torch.float64 if double_precision else torch.float32
        self.device = torch.device(device)
        self.params = GravityParams(
            interaction_strength=interaction_strength,
            softening=softening,
            dt=dt,
            noise_var=noise_var,
        )
        # an explicitly seeded dataset keys its cache on the seed, so two runs
        # that differ only in seed never replay each other's cached sims
        self._explicit_seed = seed
        seed = seed if seed is not None else random.SystemRandom().randint(0, 2**31 - 1)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._rng = random.Random(seed)  # frame order, as the JAX package draws it
        self._ready: collections.deque = collections.deque()  # gathered (Scene, y) pairs
        # loc/vel/force [B, T, N, 3], mass [B, N, 1] on the device
        self._traj: Optional[Dict[str, torch.Tensor]] = None
        self._unused: list = []
        self._mesh = None  # a data-parallel rank's mesh (``shard``)

    def shard(self, mesh) -> None:
        """Serve this rank's sims of every training batch over ``mesh``'s ``sim``
        axis, from the first rank's generator state and frame order."""
        if self.batch_size % pmesh.axis_size(mesh, pmesh.SIM_AXIS):
            raise ValueError(f"batch {self.batch_size} does not split over the sim axis")
        gen, frames = pmesh.broadcast_object((self.generator.get_state(), self._rng.getstate()))
        self.generator.set_state(gen)
        self._rng.setstate(frames)
        self._mesh = mesh

    def _whole(self, traj: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A sharded batch's sims gathered back, in rank order."""
        group = pmesh.axis_group(self._mesh, pmesh.SIM_AXIS)
        return {k: pmesh.all_gather_rows(v, group) for k, v in traj.items()}

    # ------------------------------------------------------------------ cache

    def _cache_folder(self) -> str:
        ident = {
            "dataset_name": self.dataset_name,
            "target": self.target,
            "batch_size": self.batch_size,
            "sim_length": self.sim_length,
            "sample_freq": self.sample_freq,
            "noise_var": self.noise_var,
            "num_nodes": self.num_nodes,
            "vel_norm": self.vel_norm,
            "interaction_strength": self.interaction_strength,
            "dt": self.dt,
            "softening": self.softening,
            "double_precision": self.double_precision,
            "center_of_mass": self.center_of_mass,
            "lmax_attr": self.lmax_attr,
        }
        if self._explicit_seed is not None:
            ident["seed"] = self._explicit_seed
        h = hashlib.sha256(json.dumps(ident, sort_keys=True).encode()).hexdigest()
        return os.path.join(self.cache_dir, h)

    def _save_batch_to_cache(self, traj: Dict[str, torch.Tensor]) -> None:
        """Write a private tmp file, claim the first free index with an
        ``O_EXCL`` marker, then ``os.replace`` the tmp into place: runs sharing
        a cache dir neither overwrite each other nor expose a half-written file."""
        folder = self._cache_folder()
        os.makedirs(folder, exist_ok=True)
        tmp = os.path.join(folder, f".tmp-{os.getpid()}.npz")
        try:
            np.savez_compressed(tmp, **{k: v.cpu().numpy() for k, v in traj.items()})
            existing = [int(f[:-4]) for f in os.listdir(folder)
                        if f.endswith(".npz") and not f.startswith(".tmp-")]
            idx = (max(existing) + 1) if existing else 0
            while True:
                claim = os.path.join(folder, f".claim-{idx}")
                try:
                    os.close(os.open(claim, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
                except FileExistsError:
                    idx += 1
                    continue
                os.replace(tmp, os.path.join(folder, f"{idx}.npz"))
                break
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        # sweep tmp and claim files orphaned by crashed writers over an hour ago
        # (readers index by list position, so a hole an orphan leaves is harmless)
        now = time.time()
        for f in os.listdir(folder):
            if f.startswith((".tmp-", ".claim-")):
                p = os.path.join(folder, f)
                try:
                    if now - os.path.getmtime(p) > 3600.0:
                        os.unlink(p)
                except OSError:
                    pass

    def _load_batch_from_cache(self, index: int) -> Optional[Dict[str, torch.Tensor]]:
        folder = self._cache_folder()
        if not os.path.isdir(folder):
            return None
        files = sorted(
            (f for f in os.listdir(folder) if f.endswith(".npz") and not f.startswith(".tmp-")),
            key=lambda f: int(f[:-4]),
        )
        if index >= len(files):
            return None
        with np.load(os.path.join(folder, files[index])) as z:
            return {k: torch.as_tensor(z[k], dtype=self.dtype, device=self.device)
                    for k in z.files}

    # -------------------------------------------------------------- generation

    def generate_trajectories(self, batch_size: int) -> Dict[str, torch.Tensor]:
        """``loc/vel/force [B, T, N, 3]`` and ``mass [B, N, 1]`` on the device:
        this rank's sims of them once sharded, where ``batch_size`` splits."""
        sims = 0 if self._mesh is None else pmesh.axis_size(self._mesh, pmesh.SIM_AXIS)
        if sims and batch_size % sims == 0:
            loc, vel, force, mass = sharded_datagen(
                self.generator, self._mesh, batch_size, self.num_nodes, T=self.sim_length,
                sample_freq=self.sample_freq, params=self.params, dtype=self.dtype,
                device=self.device)
            return {"loc": loc, "vel": vel, "force": force, "mass": mass}
        loc, vel, force, mass = sample_trajectory_batch(
            batch_size,
            self.num_nodes,
            T=self.sim_length,
            sample_freq=self.sample_freq,
            params=self.params,
            dtype=self.dtype,
            device=self.device,
            generator=self.generator,
        )
        return {"loc": loc, "vel": vel, "force": force, "mass": mass}

    def _load_next_batch(self) -> None:
        traj = None
        if self.cache_index >= 0:
            traj = self._load_batch_from_cache(self.cache_index)
            if traj is None:
                self.cache_index = -1  # ran out of cached sims; generate live
            else:
                self.cache_index += 1
                if self._mesh is not None:
                    traj = {k: pmesh.local_rows(v, self._mesh) for k, v in traj.items()}
        if traj is None:
            traj = self.generate_trajectories(self.batch_size)
            if self.cache_data:
                whole = traj if self._mesh is None else self._whole(traj)
                if self._mesh is None or torch.distributed.get_rank() == 0:
                    self._save_batch_to_cache(whole)
        self._traj = traj
        self._unused = list(range(int(traj["loc"].shape[1]) - 1))

    # ---------------------------------------------------------------- sampling

    def _build_target(self, traj, frame_0, frame_t) -> torch.Tensor:
        """The training target between frames ``frame_0`` and ``frame_t`` (ints,
        or index tensors of equal length, which add a frame axis after the sim
        axis)."""
        loc, vel, force = traj["loc"], traj["vel"], traj["force"]
        if self.target == "pos":
            return loc[:, frame_t]
        if self.target == "force":
            return force[:, frame_t]
        if self.target == "pos_dt+vel_dt":
            return torch.cat([loc[:, frame_t] - loc[:, frame_0],
                              vel[:, frame_t] - vel[:, frame_0]], dim=-1)
        if self.target == "pos_dt+vel":
            return torch.cat([loc[:, frame_t] - loc[:, frame_0], vel[:, frame_t]], dim=-1)
        if self.target == "pos+vel":
            return torch.cat([loc[:, frame_t], vel[:, frame_t]], dim=-1)
        if self.target == "pos_com+vel":
            com = torch.mean(loc[:, frame_0], dim=-2, keepdim=True)
            return torch.cat([loc[:, frame_t] - com, vel[:, frame_t]], dim=-1)
        raise ValueError(f"Wrong target {self.target}")

    def get_batch(self) -> Tuple[Scene, torch.Tensor]:
        """Next training batch ``(Scene [B, N], y [B, N, 3k])`` on the device."""
        if not self._ready:
            self._prefetch()
        return self._ready.popleft()

    def _prefetch(self) -> None:
        if not self._unused:
            self._load_next_batch()
        k = min(self.PREFETCH, len(self._unused))
        frames = [self._unused.pop(self._rng.randrange(len(self._unused))) for _ in range(k)]
        traj = self._traj
        f0 = torch.tensor(frames, device=self.device)
        pos, vel, force = (traj[n][:, f0] for n in ("loc", "vel", "force"))  # [B, k, N, 3]
        y = self._build_target(traj, f0, f0 + 1)
        self._ready.extend(
            (Scene(pos=pos[:, i], vel=vel[:, i], force=force[:, i], mass=traj["mass"]), y[:, i])
            for i in range(k)
        )

    def get_ground_truth_trajectories(self, batch_size: Optional[int] = None):
        """Fresh GT rollout targets ``(loc, vel, force, mass)``, the whole batch
        on every rank; never cached."""
        traj = self.generate_trajectories(batch_size or self.batch_size)
        if self._mesh is not None and traj["loc"].shape[0] != (batch_size or self.batch_size):
            traj = self._whole(traj)
        return traj["loc"], traj["vel"], traj["force"], traj["mass"]

    # ---------------------------------------------------------------- metadata

    def get_serializable_attributes(self) -> dict:
        """The JAX package's (and its reference's) ``metadata.json`` schema."""
        return {
            "dataset_name": self.dataset_name,
            "target": self.target,
            "path": self.cache_dir,
            "batch_size": self.batch_size,
            "sim_length": self.sim_length,
            "sample_freq": self.sample_freq,
            "noise_var": self.noise_var,
            "n_balls": self.num_nodes,
            "vel_norm": self.vel_norm,
            "interaction_strength": self.interaction_strength,
            "dt": self.dt,
            "softening": self.softening,
            "double_precision": self.double_precision,
            "center_of_mass": self.center_of_mass,
        }

    @classmethod
    def from_metadata(cls, metadata: dict, n_bodies: Optional[int] = None, **kw):
        """An identical dataset from a run dir's ``metadata.json``."""
        return cls(
            dataset_name=metadata.get("dataset_name", "nbody_small"),
            target=metadata.get("target", "pos_dt+vel"),
            batch_size=metadata.get("batch_size", 64),
            sim_length=metadata.get("sim_length", 10000),
            sample_freq=metadata.get("sample_freq", 10),
            noise_var=metadata.get("noise_var", 0.0),
            num_nodes=n_bodies or metadata.get("n_balls", 5),
            vel_norm=metadata.get("vel_norm", 1e-16),
            interaction_strength=metadata.get("interaction_strength", 2.0),
            dt=metadata.get("dt", 0.01),
            softening=metadata.get("softening", 0.2),
            double_precision=metadata.get("double_precision", False),
            center_of_mass=metadata.get("center_of_mass", False),
            **kw,
        )
