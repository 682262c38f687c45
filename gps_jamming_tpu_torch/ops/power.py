"""Chunked power and threshold detection (counterpart of gps_jamming_tpu.ops.power).

- The power pre-scan of the reference detector: mean |IQ|^2 per
  32768-sample chunk, a 5th-percentile baseline, a +6 dB threshold, and
  the byte ranges of the chunks above it (worker.py:198-275).
- The TDOA onset finder (triangulateTDOA.py:37-49): noise floor from the
  leading samples, a moving-average power, 50x threshold. The moving
  average is a float32 cumsum over the whole capture, as the JAX
  package's: on a long capture the running sum reaches 1e9 and more,
  where a float32 ulp is hundreds, so the card's parallel scan and the
  CPU's sequential one can put a near-threshold onset a few samples apart
  (`tdoa.file_onset` accumulates in float64 instead).
- The RSSI turn-on search and post-onset mean (triangulateRSSI.py:37-40).
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


def chunk_power_streaming_init(chunk_samples: int) -> tuple:
    """Carry of a streaming power accumulation over blocks: none, since
    `chunk_power` keeps the final partial chunk of every block."""
    del chunk_samples
    return ()


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


def mask_to_edges(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rising/falling edge flags of a boolean run-mask (worker.py:253-259):
    starts[i] where a run begins at chunk i, ends_at[i] at the last chunk
    of each run (inclusive)."""
    m = mask.to(torch.int32)
    z = torch.zeros_like(m[..., :1])
    prev = torch.cat([z, m[..., :-1]], dim=-1)
    nxt = torch.cat([m[..., 1:], z], dim=-1)
    return (m == 1) & (prev == 0), (m == 1) & (nxt == 0)


def moving_average(x: torch.Tensor, window: int) -> torch.Tensor:
    """'valid' moving average via a float32 cumsum (triangulateTDOA.py:43);
    output length n - window + 1. The division is by a tensor: CUDA would
    turn a division by a Python scalar into a multiply by its reciprocal."""
    c = torch.cumsum(torch.cat([torch.zeros_like(x[..., :1]), x], dim=-1),
                     dim=-1)
    return (c[..., window:] - c[..., :-window]) / torch.tensor(
        float(window), dtype=x.dtype, device=x.device)


def _first_true(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(index of the first True along the last axis, any True)."""
    return mask.to(torch.uint8).argmax(dim=-1), mask.any(dim=-1)


def find_onset(iq: torch.Tensor, noise_samples: int, window: int,
               threshold_factor: float) -> torch.Tensor:
    """Interference onset index (triangulateTDOA.py:37-49).

    noise floor = mean power of the first `noise_samples`; onset = first
    index where the `window`-sample moving average exceeds factor * floor,
    plus window//2 recentring. Returns -1 (int32) when not found.
    """
    power = iq.real * iq.real + iq.imag * iq.imag
    noise = power[..., :noise_samples].mean(dim=-1, keepdim=True)
    noise = torch.where(noise == 0, torch.full_like(noise, 1e-9), noise)
    idx, found = _first_true(moving_average(power, window)
                             > noise * threshold_factor)
    return torch.where(found, idx + window // 2,
                       torch.full_like(idx, -1)).to(torch.int32)


def find_first_above(amplitude: torch.Tensor,
                     threshold: float) -> torch.Tensor:
    """First index with amplitude > threshold (triangulateRSSI.py:37-40);
    -1 (int32) when the threshold is never crossed."""
    idx, found = _first_true(amplitude > threshold)
    return torch.where(found, idx, torch.full_like(idx, -1)).to(torch.int32)


def mean_after_onset(x: torch.Tensor, onset: torch.Tensor) -> torch.Tensor:
    """Mean of x[onset:] (a masked mean; onset -1 takes every sample)."""
    pos = torch.arange(x.shape[-1], device=x.device)
    m = (pos >= onset[..., None]).to(x.dtype)
    return (x * m).sum(dim=-1) / m.sum(dim=-1).clamp(min=1)
