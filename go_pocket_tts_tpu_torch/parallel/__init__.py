"""Batched serving of the port: the continuous batcher (``batching.py``)."""

from go_pocket_tts_tpu_torch.parallel.batching import BatcherRuntime, ContinuousBatcher

__all__ = ["BatcherRuntime", "ContinuousBatcher"]
