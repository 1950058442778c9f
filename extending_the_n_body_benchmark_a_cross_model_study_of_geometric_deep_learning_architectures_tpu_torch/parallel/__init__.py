"""Multi-GPU through ``torch.distributed``: the ``(sim, body)`` mesh and its
collectives (and their autograd forms), data-parallel datagen / rollout /
training, the body-sharded ring and training step (counterpart of the JAX
package's ``parallel/``)."""

from .mesh import initialize_distributed, local_rows, make_mesh, replicate  # noqa: F401
from .ring import make_ring_acceleration  # noqa: F401
from .sharded import (  # noqa: F401
    make_body_ring_rollout_fn,
    make_sharded_rollout_fn,
    make_sharded_train_step,
    shard_scene,
    sharded_datagen,
)
