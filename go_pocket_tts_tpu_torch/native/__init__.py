"""Host-side C++ helpers of the port, loaded over ``ctypes``.

``audioio.load()`` returns a wrapper around the helper library, built with
``g++`` on first use into the git-ignored ``_build/``, or ``None`` when it
cannot be built or loaded. Its callers keep a NumPy path beside it
(``utils/wav.py``, ``dsp.py``, ``flac.py``). This is host code, not a
device kernel.
"""

from go_pocket_tts_tpu_torch.native import audioio

__all__ = ["audioio"]
