"""Plain NumPy reference of what `detect --devices N` answers for a set of
RTL-SDR captures, one file per antenna, each on one time shard (the
configuration's 3 x 1 mesh).

Each file's first L samples are analysed, L the whole 32768-sample chunks
that every file holds.

- Fused PSD: each antenna's two-sided Welch over its L samples
  (`monitor.welch`, in pieces of 2^21 samples whose segment sums add up to
  the whole), the mean over antennas; its peak in dB and the peak's bin.
- Pre-scan per antenna: chunk power over the L samples
  (`monitor.chunk_power`), the 5th-percentile baseline (linear
  interpolation; one where it is not positive), the threshold baseline x
  10^(6/10), and the byte ranges [start, end) of the runs of chunks above
  it (`monitor.power_flags`), as `detect.prescan_ranges` finds them.
- Head acquisition: the PCF surface of the first `periods` code periods in
  `groups` coherent groups (`monitor.pcf_peaks`'s rows (coarse, set,
  fine)), every PRN's greatest value in each Doppler row and the row grid
  in Hz.
- TDOA: at antenna 0's first range (its start byte / 2, clamped so that
  the slice fits), a slice of `width` samples of every file; each pair's
  full linear cross-correlation r_ij[k] = sum_n a_i[n + k] conj(a_j[n]),
  |r|^2 and the integer lag of its greatest value.

Every stage's result passes through `precision.round_to`, which leaves the
float64 reference as it is and rounds the control to bfloat16.
"""
from __future__ import annotations

import itertools

import numpy as np

from . import codes
from .monitor import chunk_power, iq_from_bytes, power_flags, welch
from .precision import round_to

PIECE = 1 << 21          # samples per Welch / chunk-power piece


def analysed_samples(raws, chunk: int) -> int:
    """L: the whole chunks that every file holds, in samples."""
    n = min(r.size // 2 for r in raws)
    return (n // chunk) * chunk


def _ranges(mask: np.ndarray, chunk: int) -> list[tuple[int, int]]:
    edges = np.diff(np.concatenate([[0], mask.astype(np.int8), [0]]))
    starts = np.flatnonzero(edges == 1)
    ends = np.flatnonzero(edges == -1)
    return [(int(s) * 2 * chunk, int(e) * 2 * chunk)
            for s, e in zip(starts, ends)]


def psd_and_power(raw: np.ndarray, L: int, fs: float, nperseg: int,
                  chunk: int, precision: str = "float64"):
    """(Welch PSD (nperseg,), chunk power (L / chunk,)) of the first L
    samples of `raw`, in pieces of PIECE samples (a whole number of
    chunks): each piece's Welch takes the next nperseg / 2 samples too, so
    that every segment counts once, and the pieces' means are weighted by
    their segment counts."""
    if PIECE % chunk:
        raise ValueError(f"chunk {chunk} does not divide a piece of {PIECE}")
    hop = nperseg // 2
    acc, n_seg, pms = 0.0, 0, []
    for a in range(0, L, PIECE):
        b = min(a + PIECE, L)
        x = round_to(iq_from_bytes(raw[2 * a: 2 * min(b + hop, L)]),
                     precision)
        k = (x.size - nperseg) // hop + 1
        acc = acc + welch(x, fs, nperseg, precision) * k
        n_seg += k
        pms.append(chunk_power(x[: b - a], chunk, precision))
    return round_to(acc / n_seg, precision), np.concatenate(pms)


def prescan(pm: np.ndarray, chunk: int, percentile: float = 5.0,
            rise_db: float = 6.0) -> dict:
    base = float(np.percentile(pm, percentile))
    if base <= 0:
        base = 1.0
    return {"ranges": _ranges(power_flags(pm, percentile, rise_db), chunk),
            "baseline": base, "threshold": base * 10.0 ** (rise_db / 10.0)}


def pcf_rows(x: np.ndarray, fs: float, prns=range(1, 33),
             n_code: int = 2048, n_periods: int = 8,
             max_doppler_hz: float = 7000.0, n_sets: int = 2,
             fine_hz=(-200.0, 0.0, 200.0), n_groups: int = 2,
             precision: str = "float64") -> tuple[np.ndarray, np.ndarray]:
    """((len(prns), n_rows) greatest surface value of each PRN in each
    Doppler row, (n_rows,) the rows' Doppler in Hz), rows ordered (coarse,
    set, fine), over the first n_periods code periods of x."""
    r = lambda a: round_to(a, precision)                      # noqa: E731
    blocks = x[: n_periods * n_code].reshape(n_groups,
                                             n_periods // n_groups, n_code)
    period = n_code / fs
    bin_hz = fs / n_code
    set_off = bin_hz / n_sets
    t = np.arange(n_code) / fs
    b = np.arange(n_periods).reshape(n_groups, -1) * period   # (G, gl)
    rows = []
    for s in range(n_sets):
        for f in fine_hz:
            w = np.exp(-2j * np.pi * (f + s * set_off) * b)   # (G, gl)
            y = np.einsum("gb,gbn->gn", w, blocks)
            rows.append(r(y * np.exp(-2j * np.pi * s * set_off * t)))
    Y = r(np.fft.fft(np.stack(rows), axis=-1))                # (R, G, n)
    n_c = 2 * int(np.floor(max_doppler_hz / bin_hz)) + 1
    shifts = np.arange(n_c) - n_c // 2
    k = np.arange(n_code)
    out = []
    for prn in prns:
        rep = np.conj(np.fft.fft(codes.sampled(
            codes.gps_ca(prn), codes.GPS_CHIP_RATE_HZ, fs, n_code)))
        repc = r(rep[(k[None, :] - shifts[:, None]) % n_code])  # (C, n)
        prod = r(repc[:, None, None, :] * Y[None])             # (C, R, G, n)
        v = r(np.fft.ifft(prod, axis=-1))
        surf = r(r(v.real ** 2 + v.imag ** 2).sum(axis=2))     # (C, R, n)
        out.append(surf.max(axis=-1).reshape(-1))
    grid = (shifts[:, None, None] * bin_hz
            + (np.arange(n_sets) * set_off)[None, :, None]
            + np.asarray(fine_hz)[None, None, :]).reshape(-1)
    return np.asarray(out), grid


def pair_xcorr(slices: np.ndarray, precision: str = "float64") -> list:
    """[(i, j, lag, |r_ij|^2 over lags -(W-1)..W-1)] for every pair i < j of
    the (n_antenna, W) slices, in itertools.combinations order."""
    r = lambda a: round_to(a, precision)                      # noqa: E731
    w = slices.shape[-1]
    f = r(np.fft.fft(slices, n=2 * w, axis=-1))
    out = []
    for i, j in itertools.combinations(range(slices.shape[0]), 2):
        v = r(np.fft.ifft(r(f[i] * np.conj(f[j]))))
        p = r(v.real ** 2 + v.imag ** 2)
        p = np.concatenate([p[w + 1:], p[:w]])                # lags -(W-1)..
        out.append((i, j, int(np.argmax(p)) - (w - 1), p))
    return out


def analyse(raws, fs: float, nperseg: int, chunk: int, percentile: float,
            rise_db: float, n_code: int, periods: int, groups: int,
            max_doppler_hz: float, width: int,
            precision: str = "float64") -> dict:
    """The reference's answers for the files' bytes `raws` (one uint8
    array per antenna)."""
    L = analysed_samples(raws, chunk)
    psds, per_antenna, peaks, rows = [], [], [], []
    grid = None
    for raw in raws:
        psd, pm = psd_and_power(raw, L, fs, nperseg, chunk, precision)
        psds.append(psd)
        per_antenna.append(prescan(pm, chunk, percentile, rise_db))
        head = round_to(iq_from_bytes(raw[: 2 * periods * n_code]),
                        precision)
        rw, grid = pcf_rows(head, fs, n_code=n_code, n_periods=periods,
                            max_doppler_hz=max_doppler_hz, n_groups=groups,
                            precision=precision)
        rows.append(rw)
        peaks.append(rw.max(axis=1))
    out = {"L": L, "psd": round_to(np.mean(psds, axis=0), precision),
           "per_antenna": per_antenna, "peak": np.asarray(peaks),
           "rows": np.asarray(rows), "doppler_hz": grid, "pairs": []}
    if len(raws) >= 2:
        r0 = per_antenna[0]["ranges"]
        start = r0[0][0] // 2 if r0 else 0
        w = min(width, L)
        start = min(start, L - w)
        sl = np.stack([round_to(iq_from_bytes(raw[2 * start:
                                                  2 * (start + w)]),
                                precision) for raw in raws])
        out["start"] = start
        out["pairs"] = pair_xcorr(sl, precision)
    return out
