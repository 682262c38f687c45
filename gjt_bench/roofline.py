"""Work and bytes the kernels' algorithms need, and the least time the card
could take for them.

Counts are of the algorithm, whatever implements it: an n-point complex
FFT is 5 n log2 n float32 operations, every correlated point of a search
(product with the replica, |.|^2, the group sum) 10 more; each input byte
is read once and each output byte written once. The least time is the
larger of operations over the float32 peak and bytes over the HBM
bandwidth, from `peaks.json` (the data sheet's, stated at its power
limit); a roofline share is that time over the kernel's measured time.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

C64, F32 = 8, 4


def fft_ops(n: int) -> float:
    return 5.0 * n * math.log2(n)


def pcf_search(n: int, n_prn: int, n_c: int, n_sets: int = 2,
               n_fine: int = 3, n_groups: int = 2,
               peak_only: bool = True) -> tuple[float, float]:
    """(operations, bytes) of kernel B1's PCF search at n lags: forward FFTs
    of the n_sets * n_fine * n_groups combined rows, then per PRN, Doppler
    row and group the replica product, the inverse FFT, |.|^2 and the group
    sum. Reads the rows and the replicas; writes the per-row peak (5 stats
    planes when peak_only is False: the same count of rows)."""
    rows = n_sets * n_fine * n_groups
    ops = rows * fft_ops(n) \
        + n_prn * n_c * n_sets * n_fine * n_groups * (fft_ops(n) + 10.0 * n)
    out_rows = n_prn * n_c * n_sets * n_fine
    nbytes = rows * n * C64 + n_prn * n * C64 \
        + out_rows * F32 * (1 if peak_only else 5)
    return ops, nbytes


def welch_psd(n_samples: int, nperseg: int) -> tuple[float, float]:
    """(operations, bytes) of kernel B2's Welch PSD (50 % overlap): per
    segment the mean, the window product, the FFT and |.|^2; reads the
    complex64 samples once and writes the nperseg float32 bins."""
    hop = nperseg // 2
    n_seg = (n_samples - nperseg) // hop + 1
    ops = n_seg * (fft_ops(nperseg) + 2.0 * nperseg + 6.0 * nperseg
                   + 3.0 * nperseg)
    return ops, n_samples * C64 + nperseg * F32


def peaks(device_name: str) -> dict | None:
    table = json.loads((Path(__file__).parent / "peaks.json").read_text())
    return table.get(device_name)


def least_seconds(ops: float, nbytes: float, peak: dict) -> tuple[float, str]:
    """(seconds, 'operations' | 'bytes')."""
    t_ops = ops / peak["float32_flops"]
    t_bytes = nbytes / peak["hbm_bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
