"""Correlation-row reductions (counterpart of gps_jamming_tpu.ops.corr:
`second_peak_excluded`, `mean_excluded`)."""
from __future__ import annotations

import torch


def _circular_distance(n: int, peak_idx: torch.Tensor) -> torch.Tensor:
    """|lag - peak| on the circle of n lags, (..., n)."""
    pos = torch.arange(n, device=peak_idx.device)
    return ((pos - peak_idx[..., None] + n // 2) % n - n // 2).abs()


def second_peak_excluded(power_row: torch.Tensor, peak_idx: torch.Tensor,
                         exclude_half_width: int) -> torch.Tensor:
    """Max of a correlation row outside the circular window
    [peak - w, peak + w] (checkacquisition's second peak)."""
    dist = _circular_distance(power_row.shape[-1], peak_idx)
    return power_row.masked_fill(dist <= exclude_half_width,
                                 float("-inf")).amax(dim=-1)


def mean_excluded(power_row: torch.Tensor, peak_idx: torch.Tensor,
                  exclude_half_width: int) -> torch.Tensor:
    """Mean of a row outside the circular window around the peak. The count
    is the mask's own (at least 1); `acquisition_test_from_stats` divides
    by n - (2*w + 1) instead, which agrees only while w < n//2."""
    keep = _circular_distance(power_row.shape[-1], peak_idx) \
        > exclude_half_width
    s = torch.where(keep, power_row, torch.zeros_like(power_row)).sum(dim=-1)
    return s / keep.sum(dim=-1).clamp(min=1)
