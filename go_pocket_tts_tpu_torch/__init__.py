"""PyTorch/CUDA port of the pocket-TTS serving path, for NVIDIA Hopper.

The JAX package ``go_pocket_tts_tpu`` is the reference; this package mirrors
its module names and tensor layouts (caches ``[L,B,H,C,Dh]``, convolutions
``[B,C,T]``, repacked ConvTranspose weights) so each function here can be
held against its counterpart there. It imports ``torch`` and never ``jax``,
and nothing of the reference package.

The Pallas TPU kernels of the synthesis path are replaced by CUDA C++
kernels for ``sm_90a`` under ``csrc/``, built with ``nvcc`` on first use and
bound through ``ctypes`` (``kernels/``). Each kernel wrapper runs its plain
PyTorch version for tensors on the CPU and launches the kernel (or raises)
for tensors on a CUDA device.
"""

from go_pocket_tts_tpu_torch.device import DEFAULT_DEVICE, resolve_device

__all__ = ["DEFAULT_DEVICE", "resolve_device"]
