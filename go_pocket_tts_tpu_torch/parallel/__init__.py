"""Batched serving of the port: the continuous batcher (``batching.py``)
and its dp/tp device meshes (``mesh.py``)."""

from go_pocket_tts_tpu_torch.parallel.batching import BatcherRuntime, ContinuousBatcher
from go_pocket_tts_tpu_torch.parallel.mesh import (
    Mesh,
    dp_mesh,
    dp_tp_mesh,
    replicate_params,
    shard_batch,
    shard_params_tp,
    shard_state,
    shard_state_tp,
)

__all__ = [
    "BatcherRuntime",
    "ContinuousBatcher",
    "Mesh",
    "dp_mesh",
    "dp_tp_mesh",
    "replicate_params",
    "shard_batch",
    "shard_state",
    "shard_params_tp",
    "shard_state_tp",
]
