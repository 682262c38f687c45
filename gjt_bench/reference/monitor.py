"""Plain NumPy reference of one monitor block: what the GPS block monitor
reports for 512k samples of RTL-SDR I/Q.

- PSD: two-sided Welch (periodic Hann, 50 % overlap, each segment's complex
  mean removed, density scaling 1 / (fs * sum w^2)), natural FFT order.
- Chunk power: mean |x|^2 (+1e-10) per 32768-sample chunk, the last partial
  chunk included; flags: power above the block's 5th percentile (linear
  interpolation) times 10^(6/10), a baseline <= 0 taken as 1.
- Per-PRN peak of the PCF acquisition search (partial correlation, then an
  FFT over the blocks' phases): 10 code periods of 2048 samples in 2 groups
  of 5; the Doppler grid is every integer bin shift c (1 kHz) within +/- 7
  kHz, plus sub-bin sets s * 500 Hz (s = 0, 1), each with fine offsets f of
  -200, 0 and +200 Hz applied as a phase per code period. Row (c, s, f):
  P[p, lag] = sum_g |IFFT(FFT(y_sfg) * conj(FFT(code_p))[k - c])[lag]|^2,
  y_sfg(t) = e^{-j2pi s 500 t} sum_{b in g} e^{-j2pi (f + s 500) b T} x_b(t);
  the peak is the maximum over rows and lags.

Every stage's result passes through `precision.round_to`, which leaves the
float64 reference as it is and rounds the control to bfloat16.
"""
from __future__ import annotations

import numpy as np

from . import codes
from .precision import round_to


def iq_from_bytes(raw_u8: np.ndarray) -> np.ndarray:
    """RTL-SDR interleaved uint8 I/Q -> complex128, centred (u - 127.5)."""
    v = raw_u8.astype(np.float64) - 127.5
    return v[0::2] + 1j * v[1::2]


def welch(x: np.ndarray, fs: float, nperseg: int = 1024,
          precision: str = "float64") -> np.ndarray:
    hop = nperseg // 2
    n_seg = (x.size - nperseg) // hop + 1
    idx = np.arange(nperseg)[None, :] + hop * np.arange(n_seg)[:, None]
    seg = x[idx]
    seg = round_to(seg - seg.mean(axis=1, keepdims=True), precision)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(nperseg) / nperseg)
    spec = round_to(np.fft.fft(round_to(seg * w, precision), axis=1),
                    precision)
    p = round_to(spec.real ** 2 + spec.imag ** 2, precision)
    return round_to(p.mean(axis=0) / (fs * np.sum(w * w)), precision)


def chunk_power(x: np.ndarray, chunk: int,
                precision: str = "float64") -> np.ndarray:
    p = round_to(x.real ** 2 + x.imag ** 2, precision)
    n_full = p.size // chunk
    out = [p[: n_full * chunk].reshape(n_full, chunk).mean(axis=1)]
    if p.size % chunk:
        out.append(p[n_full * chunk:].mean(keepdims=True))
    return round_to(np.concatenate(out) + 1e-10, precision)


def power_flags(pm: np.ndarray, percentile: float = 5.0,
                rise_db: float = 6.0) -> np.ndarray:
    base = np.percentile(pm, percentile)
    if base <= 0:
        base = 1.0
    return pm > base * 10.0 ** (rise_db / 10.0)


def pcf_peaks(x: np.ndarray, fs: float, prns=range(1, 33),
              n_code: int = 2048, n_periods: int = 10,
              max_doppler_hz: float = 7000.0, n_sets: int = 2,
              fine_hz=(-200.0, 0.0, 200.0), n_groups: int = 2,
              precision: str = "float64") -> np.ndarray:
    """(len(prns),) PCF search peak per PRN over the first n_periods code
    periods of x."""
    r = lambda a: round_to(a, precision)                      # noqa: E731
    blocks = x[: n_periods * n_code].reshape(n_groups,
                                             n_periods // n_groups, n_code)
    period = n_code / fs
    set_off = fs / n_code / n_sets
    t = np.arange(n_code) / fs
    b = np.arange(n_periods).reshape(n_groups, -1) * period   # (G, gl)
    rows = []
    for s in range(n_sets):
        for f in fine_hz:
            wf = f + s * set_off
            w = np.exp(-2j * np.pi * wf * b)                  # (G, gl)
            y = np.einsum("gb,gbn->gn", w, blocks)
            rows.append(r(y * np.exp(-2j * np.pi * s * set_off * t)))
    Y = r(np.fft.fft(np.stack(rows), axis=-1))                # (R, G, n)
    n_c = 2 * int(np.floor(max_doppler_hz / (fs / n_code))) + 1
    shifts = np.arange(n_c) - n_c // 2
    k = np.arange(n_code)
    peaks = []
    for prn in prns:
        rep = np.conj(np.fft.fft(codes.sampled(
            codes.gps_ca(prn), codes.GPS_CHIP_RATE_HZ, fs, n_code)))
        repc = r(rep[(k[None, :] - shifts[:, None]) % n_code])  # (C, n)
        prod = r(repc[:, None, None, :] * Y[None])             # (C, R, G, n)
        v = r(np.fft.ifft(prod, axis=-1))
        surf = r(r(v.real ** 2 + v.imag ** 2).sum(axis=2))     # (C, R, n)
        peaks.append(surf.max())
    return np.asarray(peaks)


def block(raw_u8: np.ndarray, fs: float, nperseg: int, chunk: int,
          precision: str = "float64") -> dict:
    """The four answers of one block from its bytes."""
    x = round_to(iq_from_bytes(raw_u8), precision)
    pm = chunk_power(x, chunk, precision)
    return {"psd": welch(x, fs, nperseg, precision), "pm": pm,
            "flags": power_flags(pm),
            "peak": pcf_peaks(x, fs, precision=precision)}
