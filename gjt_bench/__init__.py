"""The benchmark of the PyTorch/CUDA port (see harness.py)."""
