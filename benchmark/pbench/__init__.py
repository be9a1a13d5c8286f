"""The benchmark harness of the PyTorch and CUDA port (``benchmark/run.py``)."""
