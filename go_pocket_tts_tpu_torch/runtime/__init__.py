"""Generation runtime of the port: prefill, AR loop and decode on the GPU,
one-shot (``generate.py``) or streamed frame by frame (``streaming.py``),
with voice conditioning and continuity sessions."""

from go_pocket_tts_tpu_torch.runtime.generate import ContinuationState, GenerateConfig, GPURuntime
from go_pocket_tts_tpu_torch.runtime.streaming import stream_generate, stream_generate_session

__all__ = ["ContinuationState", "GenerateConfig", "GPURuntime", "stream_generate", "stream_generate_session"]
