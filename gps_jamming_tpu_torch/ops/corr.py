"""Correlation (counterpart of gps_jamming_tpu.ops.corr): the circular FFT
correlation power of the reference's acquisition engine (`cpxconv`,
sdrcmn.c:124-147), the full linear cross-correlation of the TDOA pairs (scipy.signal.correlate(a, b, 'full')
as triangulateTDOA.py:86-89 uses it) with a parabolic sub-sample peak, and
the acquisition rows' excluded-peak reductions (checkacquisition).

The JAX package's planar `_p` forms work around the TPU's missing complex
dtype; here the complex64 tensors go straight to torch.fft (cuFFT on the
card).
"""
from __future__ import annotations

import math

import torch


def circular_correlation_power(x: torch.Tensor,
                               replica_fft_conj: torch.Tensor) -> torch.Tensor:
    """|IFFT(FFT(x) * conj(FFT(replica)))|^2 over every circular lag
    (cpxconv, sdrcmn.c:124-147).

    x: (..., n) complex64 block; replica_fft_conj: (..., n) precomputed
    conj(FFT(code replica)). Returns float32 (..., n).
    """
    v = torch.fft.ifft(torch.fft.fft(x, dim=-1) * replica_fft_conj, dim=-1)
    return v.real * v.real + v.imag * v.imag


def xcorr_full(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full linear cross-correlation by zero-padded FFTs at the JAX
    package's nfft = 2**ceil(log2(na + nb - 1)).

    out[k] = sum_n a[n + k - (nb-1)] * conj(b[n]), length na + nb - 1; the
    lag of index m is m - (nb - 1) (scipy's 'full' order).
    """
    na, nb = a.shape[-1], b.shape[-1]
    nfft = 1 << math.ceil(math.log2(na + nb - 1))
    full = torch.fft.ifft(torch.fft.fft(a, n=nfft, dim=-1)
                          * torch.fft.fft(b, n=nfft, dim=-1).conj(), dim=-1)
    idx = (torch.arange(na + nb - 1, device=a.device) - (nb - 1)) % nfft
    return full[..., idx]


def argmax_lag(corr_mag: torch.Tensor, nb: int) -> torch.Tensor:
    """Integer lag of the correlation peak: argmax - (nb - 1)."""
    return (corr_mag.argmax(dim=-1) - (nb - 1)).to(torch.int32)


def parabolic_peak_offset(y: torch.Tensor,
                          peak_idx: torch.Tensor) -> torch.Tensor:
    """Sub-sample offset of a discrete peak by a 3-point parabola fit:
    0.5*(y[-1] - y[+1]) / (y[-1] - 2*y[0] + y[+1]), clamped to [-0.5,
    0.5]; 0 at the array edge or where |denominator| <= 1e-12 (a flat
    peak)."""
    n = y.shape[-1]

    def at(i):
        return y.gather(-1, i.clamp(0, n - 1)[..., None])[..., 0]

    ym, y0, yp = at(peak_idx - 1), at(peak_idx), at(peak_idx + 1)
    denom = ym - 2.0 * y0 + yp
    offset = torch.where(denom.abs() > 1e-12, 0.5 * (ym - yp) / denom,
                         torch.zeros_like(denom)).clamp(-0.5, 0.5)
    at_edge = (peak_idx <= 0) | (peak_idx >= n - 1)
    return torch.where(at_edge, torch.zeros_like(offset), offset)


def xcorr_peak_lag(a: torch.Tensor, b: torch.Tensor,
                   subsample: bool = True):
    """Cross-correlation peak lag (float32 samples, b relative to a) and
    its magnitude: the integer part of triangulateTDOA.py:86-89 plus the
    parabolic refinement."""
    nb = b.shape[-1]
    c = xcorr_full(a, b)
    mag = torch.sqrt(c.real * c.real + c.imag * c.imag)
    peak = mag.argmax(dim=-1)
    lag = (peak - (nb - 1)).to(torch.float32)
    if subsample:
        lag = lag + parabolic_peak_offset(mag, peak)
    return lag, mag.gather(-1, peak[..., None])[..., 0]


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
