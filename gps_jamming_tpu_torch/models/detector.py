"""Power pre-scan of the jamming detector (counterpart of the power-profile
part of gps_jamming_tpu.models.detector).

Chunk power map -> 5th-percentile baseline -> +6 dB threshold -> the byte
ranges of the chunks above it (the reference's worker.py:198-275).
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..config import DetectorConfig
from ..device import as_device
from ..ops import iq as iq_ops
from ..ops import power as power_ops


class PowerProfile(NamedTuple):
    power_map: torch.Tensor       # (n_chunks,) mean |IQ|^2 per chunk
    baseline: torch.Tensor        # 0-d, the percentile baseline
    threshold: torch.Tensor       # 0-d, linear
    mask: torch.Tensor            # (n_chunks,) bool, above threshold


def _profile(pm: torch.Tensor, cfg: DetectorConfig) -> PowerProfile:
    base = power_ops.power_baseline(pm, cfg.baseline_percentile)
    thr = power_ops.power_threshold_linear(base, cfg.power_rise_db)
    return PowerProfile(pm, base, thr, pm > thr)


def power_profile(iq: torch.Tensor, cfg: DetectorConfig) -> PowerProfile:
    """Chunk power map + baseline + threshold mask of a complex64 capture."""
    return _profile(power_ops.chunk_power(iq, cfg.power_chunk_samples), cfg)


def power_profile_file(path: str, cfg: DetectorConfig,
                       max_samples: int | None = None,
                       block_chunks: int = 256,
                       device=None) -> PowerProfile:
    """Power pre-scan of a .bin capture in bounded memory.

    Reads `block_chunks` chunks at a time (16 MiB of bytes at the default
    32768-sample chunk), ingests them with the int8 'centered' convention
    on `device` (None: the card), and keeps the final partial chunk: the
    map equals `power_profile` of the whole capture on the same bytes.
    """
    device = as_device(device)
    chunk = cfg.power_chunk_samples
    block = block_chunks * chunk
    n_total = os.path.getsize(path) // 2
    if max_samples is not None:
        n_total = min(n_total, int(max_samples))
    pms = []
    with open(path, "rb") as f:
        done = 0
        while done < n_total:
            m = min(block, n_total - done)
            raw = np.fromfile(f, dtype=np.uint8, count=2 * m)
            if raw.size == 0:
                break
            x8 = torch.from_numpy(iq_ops.uint8_np_to_int8(raw)).to(device)
            pms.append(power_ops.chunk_power(iq_ops.int8_to_complex(x8),
                                             chunk))
            done += raw.size // 2
    pm = torch.cat(pms) if pms else torch.zeros(0, device=device)
    return _profile(pm, cfg)


def power_profile_ranges(profile: PowerProfile,
                         cfg: DetectorConfig) -> list[tuple[int, int]]:
    """High-power byte ranges [(start_byte, end_byte))."""
    return power_ops.extract_ranges(profile.mask, cfg.power_chunk_samples * 2)
