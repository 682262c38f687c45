"""Build and load of the port's CUDA kernels (see build.py)."""
