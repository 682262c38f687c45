"""PCF acquisition surface (counterpart of gps_jamming_tpu.ops.caf:
`doppler_bins`, `pcf_doppler_hz`, `pcf_profitable`, `caf_accumulate_pcf`).

The post-correlation-FFT search factorizes the Doppler axis into integer
FFT-bin shifts of the replica (coarse), n_sets sub-bin mixes (sets) and a
small DFT across the blocks of each coherent group (fine). The per-Doppler
("std") search, `caf_accumulate`, is kernel B3 and not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from . import cuda_pcf


def doppler_bins(max_hz: float, step_hz: float) -> np.ndarray:
    """Symmetric Doppler grid (71 bins at +/-7 kHz, 200 Hz)."""
    n = int(round(2 * max_hz / step_hz)) + 1
    return (np.arange(n) * step_hz - max_hz).astype(np.float32)


def pcf_doppler_hz(sample_rate: float, n: int, max_doppler_hz: float,
                   n_sets: int = 2,
                   fine_hz=(-200.0, 0.0, 200.0)) -> np.ndarray:
    """The (n_coarse * n_sets * n_fine,) Doppler grid of caf_accumulate_pcf,
    ordered (coarse, set, fine) like the surface's Doppler axis."""
    bin_hz = sample_rate / n
    n_c = cuda_pcf.n_coarse(sample_rate, n, max_doppler_hz)
    cvals = (np.arange(n_c) - n_c // 2) * bin_hz
    sets = np.arange(n_sets) * (bin_hz / n_sets)
    fine = np.asarray(fine_hz, np.float64)
    d = (cvals[:, None, None] + sets[None, :, None] + fine[None, None, :])
    return d.reshape(-1).astype(np.float32)


def pcf_profitable(n: int, n_blocks: int, sample_rate: float,
                   max_doppler_hz: float, n_freq_std: int,
                   n_sets: int = 2, n_fine: int = 3,
                   n_groups: int = 2) -> bool:
    """Does the PCF factorization run fewer inverse-FFT rows than the
    per-Doppler search for this geometry? (GPS 1 ms blocks: yes; Galileo
    E1B 4 ms blocks: no.)"""
    n_c = cuda_pcf.n_coarse(sample_rate, n, max_doppler_hz)
    return n_c * n_sets * n_fine * n_groups < n_freq_std * n_blocks


def caf_accumulate_pcf(blocks: torch.Tensor, replica_fft_conj: torch.Tensor,
                       sample_rate: float, max_doppler_hz: float = 7000.0,
                       n_sets: int = 2, fine_hz=(-200.0, 0.0, 200.0),
                       n_groups: int = 2) -> torch.Tensor:
    """Acquisition surface by the PCF search.

    blocks: (n_blocks, n) complex64, one code period each, n_blocks a
    multiple of n_groups. replica_fft_conj: (n_prn, n) complex64. Returns
    float32 (n_prn, n_coarse*n_sets*n_fine, n); the Doppler of axis-1 index
    i is pcf_doppler_hz(...)[i].

    This is kernel B1 through `cuda_pcf.caf_accumulate_pcf_fused`: on a
    CUDA tensor it launches the kernel where the JAX package takes its
    Pallas kernel; on the CPU it runs the kernel's plain version.
    """
    return cuda_pcf.caf_accumulate_pcf_fused(
        blocks, replica_fft_conj, sample_rate, max_doppler_hz=max_doppler_hz,
        n_sets=n_sets, fine_hz=fine_hz, n_groups=n_groups)
