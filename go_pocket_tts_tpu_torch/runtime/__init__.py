"""Generation runtime of the port: prefill, AR loop and decode on the GPU."""

from go_pocket_tts_tpu_torch.runtime.generate import GenerateConfig, GPURuntime

__all__ = ["GenerateConfig", "GPURuntime"]
