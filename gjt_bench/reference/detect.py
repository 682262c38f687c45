"""Plain NumPy reference of what the `detect` path answers for a set of
RTL-SDR captures (the upstream worker.py flow).

- Pre-scan: chunk power of the first antenna's whole capture (32768-sample
  chunks, the last partial one included), 5th-percentile baseline, +6 dB;
  the byte ranges [start, end) of the runs of chunks above it.
- Acquisition: at a sample `start`, 10 code periods searched over every
  satellite (GPS PRN, or GLONASS channel k at its FDMA offset) and Doppler
  bins of `step_hz` within +/- max_hz: per Doppler, the circular
  correlation of each 1 ms period with the code, |.|^2 summed over the 10.
  Peak ratio: the peak over the highest value of its Doppler row outside
  +/- 2 chips of the peak's lag. Code phase: the lag in samples where
  x[i] ~ code[i - lag]. Doppler: the bin, refined by the phase turn between
  consecutive 1 ms prompt correlations, squared so that a data transition
  does not flip it.
- The 4-flag detector (worker.py:363-458) over 100 ms telemetry frames:
  F1 a frame whose byte offset falls in a pre-scan range, confirmed at
  once; F2 a C/N0 8 dB under the median of the last 100 clean frames'
  C/N0 (float32, as the upstream's), confirmed after 2.5 s; F3/F4 need a
  fix and stay off without one; an event clears after 2.0 s without a
  flag, and an event still open at the end closes at the last frame.
- RSSI: per antenna the first sample whose normalized amplitude
  (|u - 127.5| / 127.5) exceeds 0.1, the mean amplitude from there to the
  end, Prx = 20 log10(mean), d = 10^((P - Prx - PL(1 m)) / (10 n)); the
  location is the point of a 300 x 300 grid over the antennas' centre +/-
  1.5 max(d) that minimises sum |dist - d|, the lowest index on a tie.
"""
from __future__ import annotations

import math

import numpy as np

from . import codes
from .monitor import chunk_power, iq_from_bytes
from .precision import round_to

CHUNK = 32768


def prescan_ranges(raw_u8: np.ndarray, chunk: int = CHUNK,
                   percentile: float = 5.0, rise_db: float = 6.0,
                   precision: str = "float64") -> list[tuple[int, int]]:
    pm = chunk_power(round_to(iq_from_bytes(raw_u8), precision), chunk,
                     precision)
    base = np.percentile(pm, percentile)
    if base <= 0:
        base = 1.0
    mask = pm > base * 10.0 ** (rise_db / 10.0)
    edges = np.diff(np.concatenate([[0], mask.astype(np.int8), [0]]))
    starts = np.flatnonzero(edges == 1)
    ends = np.flatnonzero(edges == -1)
    return [(int(s) * 2 * chunk, int(e) * 2 * chunk)
            for s, e in zip(starts, ends)]


def _code_table(system: str, ids, fs: float, n: int):
    """(len(ids), n) sampled codes, each id's carrier offset (Hz), and the
    chip rate."""
    if system == "gps":
        tab = np.stack([codes.sampled(codes.gps_ca(p),
                                      codes.GPS_CHIP_RATE_HZ, fs, n)
                        for p in ids])
        return tab, np.zeros(len(ids)), codes.GPS_CHIP_RATE_HZ
    st = codes.sampled(codes.glonass_st(), codes.GLO_CHIP_RATE_HZ, fs, n)
    return (np.repeat(st[None], len(ids), axis=0),
            np.asarray(ids, np.float64) * codes.GLO_SPACING_HZ,
            codes.GLO_CHIP_RATE_HZ)


def acquire(raw_u8: np.ndarray, start: int, system: str, ids, fs: float,
            max_hz: float = 7000.0, step_hz: float = 250.0,
            n_periods: int = 10) -> dict:
    """{id: (peak_ratio, code_phase_samples, doppler_hz)} at sample
    `start`."""
    n = int(round(fs * 1e-3))
    x = iq_from_bytes(raw_u8[2 * start: 2 * (start + n_periods * n)])
    tab, offsets, chip_rate = _code_table(system, ids, fs, n)
    rep = np.conj(np.fft.fft(tab, axis=1))                    # (S, n)
    t = np.arange(n_periods * n) / fs
    dopp = np.arange(-max_hz, max_hz + step_hz / 2, step_hz)
    excl = int(math.ceil(2.0 * fs / chip_rate))
    out = {}
    for j, sid in enumerate(ids):
        best = None
        for d in dopp:
            z = (x * np.exp(-2j * np.pi * (offsets[j] + d) * t)).reshape(
                n_periods, n)
            c = np.fft.ifft(np.fft.fft(z, axis=1) * rep[j], axis=1)
            p = (c.real ** 2 + c.imag ** 2).sum(axis=0)
            k = int(np.argmax(p))
            if best is None or p[k] > best[0]:
                best = (p[k], k, d, p, c[:, k])
        pk, lag, d, row, prompt = best
        dist = np.abs((np.arange(n) - lag + n // 2) % n - n // 2)
        second = row[dist > excl].max()
        turn = np.sum((prompt[1:] * np.conj(prompt[:-1])) ** 2)
        d_fine = d + np.angle(turn) / (2.0 * 2.0 * np.pi * 1e-3)
        out[int(sid)] = (float(pk / second), int(lag), float(d_fine))
    return out


def frame_cn0(cn0_epochs: np.ndarray, n_epochs: int) -> np.ndarray:
    """C/N0 telemetry of each 100 ms frame of an `n_epochs` ms capture: the
    epoch series read at the frame's last epoch (the upstream's per-record
    snapshot)."""
    n_frames = n_epochs // 100
    out = np.zeros(n_frames, np.float32)
    if cn0_epochs is None or cn0_epochs.size == 0:
        return out
    for f in range(n_frames):
        e = min((f + 1) * 100, n_epochs - 1)
        out[f] = cn0_epochs[min(e, cn0_epochs.size - 1)]
    return out


def detector_events(ranges, cn0: np.ndarray, n_epoch_samples: int,
                    confirm_s: float = 2.5, clear_s: float = 2.0,
                    drop_db: float = 8.0, hist_len: int = 100,
                    min_hist: int = 40) -> list[tuple[int, int, float, float]]:
    """(start_byte, end_byte, start_s, end_s) events over the frames of
    `cn0` (one per 100 ms)."""
    f32 = np.float32
    jamming = False
    pot_start_t = None
    pot_start_b = 0
    pot_end_t = None
    act_t, act_b = 0.0, 0
    hist: list = []
    events = []
    t = 0.0
    b = 0
    for f in range(cn0.size):
        # the upstream's float64 frame time, so that the 2.5 s and 2.0 s
        # comparisons round as its own do
        t = (f + 1) * 100 * 1e-3
        b = (f + 1) * 100 * n_epoch_samples * 2
        hit = [r for r in ranges if r[0] <= b <= r[1]]
        f1 = bool(hit)
        c = f32(cn0[f])
        if not jamming and c > 0:
            hist = (hist + [c])[-hist_len:]
        if len(hist) > 10:
            s = sorted(hist)
            med = f32(0.5) * (s[(len(s) - 1) // 2] + s[len(s) // 2])
        else:
            med = c
        f2 = len(hist) > min_hist and c < med - f32(drop_db)
        now = f1 or f2
        if not jamming:
            if now and f1:
                jamming = True
                act_t, act_b = t, hit[0][0]
            elif now:
                if pot_start_t is None:
                    pot_start_t, pot_start_b = t, b
                if t - pot_start_t >= confirm_s:
                    jamming = True
                    act_t = pot_start_t
                    act_b = pot_start_b if pot_start_b > 0 else b
            else:
                pot_start_t = None
            pot_end_t = None
        elif now:
            pot_end_t = None
        else:
            if pot_end_t is None:
                pot_end_t = t
            if t - pot_end_t >= clear_s:
                events.append((act_b, b, act_t, t))
                jamming = False
                pot_end_t = None
    if cn0.size and jamming:
        events.append((act_b, b, act_t, t))
    return events


def rssi(raws, positions, tx_power_dbm: float = 40.0, n: float = 3.0,
         frequency_mhz: float = 1575.42, threshold: float = 0.1,
         grid: int = 300, span_x: float = 1.5,
         precision: str = "float64"):
    """(distances (n_ant,), location (2,) or None)."""
    dists = []
    for raw in raws:
        amp = round_to(np.abs(iq_from_bytes(raw)) / 127.5, precision)
        above = np.flatnonzero(amp > threshold)
        if above.size == 0:
            dists.append(float("nan"))
            continue
        mean = round_to(np.asarray(amp[above[0]:].mean()), precision)
        prx = 20.0 * np.log10(max(float(mean), 1e-12))
        pl1 = 20.0 * np.log10(frequency_mhz) - 27.55
        dists.append(float(10.0 ** ((tx_power_dbm - prx - pl1) / (10.0 * n))))
    ok = [i for i, d in enumerate(dists) if np.isfinite(d)]
    if len(ok) < 2:
        return np.asarray(dists), None
    pos = np.asarray([positions[i] for i in ok], np.float64)
    r = np.asarray([dists[i] for i in ok])
    span = r.max() * span_x
    c = pos.mean(axis=0)
    xs = np.linspace(c[0] - span, c[0] + span, grid)
    ys = np.linspace(c[1] - span, c[1] + span, grid)
    d = np.sqrt((xs[None, :, None] - pos[:, 0]) ** 2
                + (ys[:, None, None] - pos[:, 1]) ** 2)
    err = np.abs(d - r).sum(axis=-1)
    k = int(np.argmin(err))
    return np.asarray(dists), np.array([xs[k % grid], ys[k // grid]])
