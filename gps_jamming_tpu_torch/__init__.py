"""gps_jamming_tpu_torch: the PyTorch/CUDA port of gps_jamming_tpu.

The detect + acquire main path (int8 I/Q ingest, Welch PSD, chunk-power
flags, PCF GPS acquisition) on complex64 tensors. On a CUDA tensor the Welch
PSD and the PCF search run as hand-written sm_90a kernels (`csrc/`), built
at first use; on a CPU tensor they run their plain PyTorch versions.
Importing the package builds nothing and loads no JAX.
"""

__version__ = "0.1.0"
