"""Chunked power and threshold detection (counterpart of gps_jamming_tpu.ops.power).

The power pre-scan of the reference detector: mean |IQ|^2 per 32768-sample
chunk, a 5th-percentile baseline, a +6 dB threshold, and the byte ranges of
the chunks above it.
"""
from __future__ import annotations

import numpy as np
import torch

from .iq import frame_nonoverlap


def chunk_power(iq: torch.Tensor, chunk_samples: int) -> torch.Tensor:
    """mean(I^2 + Q^2) + 1e-10 per non-overlapping chunk, INCLUDING the
    final partial chunk. complex64 (..., n) -> float32
    (..., ceil(n / chunk_samples))."""
    p = iq.real * iq.real + iq.imag * iq.imag
    n = p.shape[-1]
    n_full = n // chunk_samples
    out = []
    if n_full:
        out.append(frame_nonoverlap(p[..., : n_full * chunk_samples],
                                    chunk_samples).mean(dim=-1))
    if n % chunk_samples:
        out.append(p[..., n_full * chunk_samples:].mean(dim=-1, keepdim=True))
    pm = out[0] if len(out) == 1 else torch.cat(out, dim=-1)
    return pm + 1e-10


def power_baseline(power_map: torch.Tensor,
                   percentile: float = 5.0) -> torch.Tensor:
    """Noise-floor baseline: the linear-interpolation percentile of the
    chunk powers (np.percentile's default); a non-positive baseline is
    clamped to 1.0. Returns a 0-d tensor."""
    base = torch.quantile(power_map.reshape(-1), percentile / 100.0)
    return torch.where(base <= 0, torch.ones_like(base), base)


def power_threshold_linear(baseline: torch.Tensor,
                           rise_db: float) -> torch.Tensor:
    """baseline * 10^(rise_db/10)."""
    return baseline * 10.0 ** (rise_db / 10.0)


def above_threshold_mask(power_map: torch.Tensor,
                         threshold: torch.Tensor) -> torch.Tensor:
    return power_map > threshold


def extract_ranges(mask, chunk_size_bytes: int) -> list[tuple[int, int]]:
    """Boolean chunk mask -> [(start_byte, end_byte)) runs, exclusive end."""
    if isinstance(mask, torch.Tensor):
        mask = mask.detach().cpu().numpy()
    mask = np.asarray(mask).astype(bool)
    if mask.size == 0 or not mask.any():
        return []
    d = np.diff(mask.astype(np.int8))
    starts = list(np.where(d == 1)[0] + 1)
    ends = list(np.where(d == -1)[0] + 1)
    if mask[0]:
        starts.insert(0, 0)
    if mask[-1]:
        ends.append(mask.size)
    return [(int(s) * chunk_size_bytes, int(e) * chunk_size_bytes)
            for s, e in zip(starts, ends)]
