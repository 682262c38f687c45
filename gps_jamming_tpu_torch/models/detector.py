"""Jamming detectors (counterpart of gps_jamming_tpu.models.detector).

- The power pre-scan: chunk power map -> 5th-percentile baseline -> +6 dB
  threshold -> the byte ranges of the chunks above it (the reference's
  worker.py:198-275), on the device.
- The standalone chunk detector and its median * 4.8 calibration
  (checkIfJamming.py:7-67, :94-95).
- The 4-flag event state machine (worker.py:363-458): F1 power, F2 C/N0
  drop, F3 residual integrity, F4 altitude, with confirm/clear hysteresis.
  The JAX package runs it as a `lax.scan` under `jax.enable_x64`; there is
  one row per 100 ms telemetry frame, so here it is a host loop over
  frames in NumPy with the reference's dtypes: int64 byte offsets, float64
  times, and float32 C/N0, residual, height and satellite count. The C/N0
  median, its 8 dB drop and the comparison are float32, as the JAX
  package computes them (a Python float there is weakly typed), so F2
  falls on the same side of a tie.
- The event table keeps the reference's 64 rows: event k is written at
  row k % MAX_EVENTS, and `events_to_list` returns the rows in row order,
  so after 64 events the newest overwrite the oldest.
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

MAX_EVENTS = 64
MAX_RANGES = 64


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


def ranges_to_padded(ranges: list[tuple[int, int]],
                     max_ranges: int = MAX_RANGES) -> tuple[np.ndarray, int]:
    """Pad byte ranges to a static-shape (max_ranges, 2) int64 array."""
    arr = np.full((max_ranges, 2), -1, dtype=np.int64)
    n = min(len(ranges), max_ranges)
    for i in range(n):
        arr[i] = ranges[i]
    return arr, n


# ---------------------------------------------------------------------------
# Standalone chunk detector (checkIfJamming)
# ---------------------------------------------------------------------------

def standalone_chunk_powers(iq: torch.Tensor,
                            cfg: DetectorConfig) -> torch.Tensor:
    """Per-chunk mean |IQ|^2 with the standalone detector's chunk size
    (131072 bytes = 65536 samples, checkIfJamming.py:5)."""
    return power_ops.chunk_power(iq, cfg.standalone_chunk_bytes // 2) - 1e-10


def standalone_events(chunk_powers, threshold: float,
                      chunk_samples: int) -> list[tuple[int, int]]:
    """(start_sample, end_sample) events, matching analyze_file_for_jamming
    (checkIfJamming.py:22-63): edges at chunk boundaries, trailing event
    closed at the end of the file."""
    return power_ops.extract_ranges(_host(chunk_powers) > threshold,
                                    chunk_samples)


def calibrate_threshold(chunk_powers: torch.Tensor,
                        factor: float = 4.8) -> torch.Tensor:
    """Suggested threshold = median * 4.8 (checkIfJamming.py:94-95); the
    median of an even count is the mean of the two middle values, as
    np.median's (torch.median would take the lower one)."""
    return torch.quantile(chunk_powers.reshape(-1), 0.5) * factor


# ---------------------------------------------------------------------------
# 4-flag detector state machine
# ---------------------------------------------------------------------------

class TelemetryFrames(NamedTuple):
    """Telemetry inputs, one row per 100 ms frame (sdrout.c cadence). All
    arrays shape (n_frames,); `run_detector` casts them to the reference's
    dtypes."""
    time_s: np.ndarray
    buffcnt: np.ndarray           # byte offset into the capture (int64)
    cn0_avg: np.ndarray           # mean C/N0 across tracked sats (0 if none)
    residual_median: np.ndarray
    residual_bad_count: np.ndarray  # sats with residual > single-sat threshold
    hgt: np.ndarray
    nsat: np.ndarray


class DetectorState(NamedTuple):
    jamming: bool
    pot_start_t: float                 # float64; -1 = None
    pot_start_buffcnt: int             # int64
    pot_end_t: float                   # float64; -1 = None
    active_start_t: float
    active_start_buffcnt: int
    cn0_hist: np.ndarray               # (hist_len,) float32 ring buffer
    hist_count: int
    hist_pos: int
    events: np.ndarray                 # (MAX_EVENTS, 4) float64 start_b, end_b, t0, t1
    n_events: int


class DetectorTrace(NamedTuple):
    is_jamming: np.ndarray
    f1: np.ndarray
    f2: np.ndarray
    f3: np.ndarray
    f4: np.ndarray
    median_cn0: np.ndarray


def init_state(cfg: DetectorConfig) -> DetectorState:
    """Zero state; event rows are float64 (exact for offsets up to 2^53)."""
    return DetectorState(
        jamming=False, pot_start_t=-1.0, pot_start_buffcnt=0,
        pot_end_t=-1.0, active_start_t=0.0, active_start_buffcnt=0,
        cn0_hist=np.zeros(cfg.cn0_history_len, np.float32),
        hist_count=0, hist_pos=0,
        events=np.full((MAX_EVENTS, 4), -1.0, np.float64), n_events=0)


def _ring_median(hist: np.ndarray, count: int) -> np.float32:
    """np.median over the `count` valid entries of the ring buffer, in
    float32."""
    n = hist.shape[0]
    vals = np.sort(np.where(np.arange(n) < count, hist, np.float32(np.inf)))
    c = max(count, 1)
    lo = vals[max((c - 1) // 2, 0)]
    hi = vals[max(c // 2, 0)]
    return np.float32(0.5) * (lo + hi)


def _f1_lookup(buffcnt: int, ranges: np.ndarray, n_ranges: int):
    """F1 flag + start byte of the first range holding the frame
    (worker.py:366-370, :419-423). ranges: (MAX_RANGES, 2) int64, -1
    padded."""
    for i in range(n_ranges):
        if ranges[i, 0] <= buffcnt <= ranges[i, 1]:
            return True, int(ranges[i, 0])
    return False, buffcnt


def four_flag_step(state: DetectorState, frame, ranges: np.ndarray,
                   n_ranges: int, cfg: DetectorConfig):
    """One telemetry frame through the reference's detector logic.

    frame: (t float64, buffcnt int, cn0, residual_median, bad_count, hgt,
    nsat), the last five np.float32."""
    t, buffcnt, cn0, res_med, bad_cnt, hgt, nsat = frame
    f32 = np.float32

    f1, f1_start_byte = _f1_lookup(buffcnt, ranges, n_ranges)

    # C/N0 history (worker.py:320-325): append only when not jamming and
    # cn0 > 0; the median is used once the history holds more than 10
    hist, hist_count, hist_pos = (state.cn0_hist, state.hist_count,
                                  state.hist_pos)
    if not state.jamming and cn0 > 0:
        hist = hist.copy()
        hist[hist_pos] = cn0
        hist_count = min(hist_count + 1, hist.shape[0])
        hist_pos = (hist_pos + 1) % hist.shape[0]
    median_cn0 = _ring_median(hist, hist_count) if hist_count > 10 else cn0

    f2 = bool(hist_count > cfg.cn0_min_history
              and cn0 < median_cn0 - f32(cfg.cn0_drop_db))
    f3 = bool(res_med > f32(cfg.residual_median_m)
              or bad_cnt >= f32(cfg.min_bad_sats))
    f4 = bool(nsat > 0 and abs(hgt) > f32(cfg.max_altitude_m))
    nav_issue = (f3 or f4) and bool(nsat > 0)
    now = f1 or f2 or nav_issue

    # not jamming: confirmation (worker.py:391-402, :415-431)
    armed = state.pot_start_t >= 0
    pot_start_new = state.pot_start_t if armed else t
    pot_start_buff_new = state.pot_start_buffcnt if armed else buffcnt
    sustained = (t - pot_start_new) >= cfg.confirm_duration_s
    confirm_f1 = not state.jamming and now and f1
    confirm_slow = not state.jamming and now and not f1 and sustained
    confirm = confirm_f1 or confirm_slow
    if confirm_f1:
        start_byte = f1_start_byte
    else:
        start_byte = pot_start_buff_new if pot_start_buff_new > 0 \
            else buffcnt
    start_time = pot_start_new if confirm_slow else t

    # jamming: clear (worker.py:403-413), then the event row
    # (confirm_jamming_end, worker.py:441-458)
    pot_end_new = state.pot_end_t if state.pot_end_t >= 0 else t
    clear = (state.jamming and not now
             and (t - pot_end_new) >= cfg.clear_duration_s)
    events, n_events = state.events, state.n_events
    if clear:
        events = events.copy()
        events[n_events % MAX_EVENTS] = (state.active_start_buffcnt,
                                         buffcnt, state.active_start_t, t)
        n_events += 1
    jamming_next = (not clear) if state.jamming else confirm

    # The reference's state retention: pot_start_t is set only when the
    # slow path first trips while not jamming, reset only by a clean frame
    # while not jamming, and kept through an active event (a relapse right
    # after an event confirms at once with the old potential start);
    # pot_start_buffcnt is never reset.
    slow_arm = not state.jamming and now and not f1 and not armed
    if not state.jamming and not now:
        pot_start_t = -1.0
    else:
        pot_start_t = t if slow_arm else state.pot_start_t
    new_state = DetectorState(
        jamming=jamming_next,
        pot_start_t=pot_start_t,
        pot_start_buffcnt=buffcnt if slow_arm else state.pot_start_buffcnt,
        pot_end_t=(pot_end_new if state.jamming and not now and not clear
                   else -1.0),
        active_start_t=start_time if confirm else state.active_start_t,
        active_start_buffcnt=(start_byte if confirm
                              else state.active_start_buffcnt),
        cn0_hist=hist, hist_count=hist_count, hist_pos=hist_pos,
        events=events, n_events=n_events)
    trace = (jamming_next, f1, f2, f3 and bool(nsat > 0), f4, median_cn0)
    return new_state, trace


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def run_detector(frames: TelemetryFrames, ranges: np.ndarray, n_ranges: int,
                 cfg: DetectorConfig) -> tuple[DetectorState, DetectorTrace]:
    """Run the telemetry stream through the detector, on the host.

    Returns the final state (with the padded event table) and the
    per-frame flag trace. A still-open event at stream end is closed at
    the last frame (the worker's finally-block behavior, worker.py:523).
    """
    ranges = np.asarray(_host(ranges), np.int64)
    n_ranges = int(n_ranges)
    time_s = np.asarray(_host(frames.time_s), np.float64)
    buffcnt = np.asarray(_host(frames.buffcnt), np.int64)
    cols = [np.asarray(_host(a), np.float32) for a in (
        frames.cn0_avg, frames.residual_median, frames.residual_bad_count,
        frames.hgt, frames.nsat)]
    state = init_state(cfg)
    rows = []
    for i in range(time_s.shape[0]):
        state, tr = four_flag_step(
            state, (float(time_s[i]), int(buffcnt[i]),
                    *(c[i] for c in cols)), ranges, n_ranges, cfg)
        rows.append(tr)
    if time_s.shape[0] > 0 and state.jamming:
        events = state.events.copy()
        events[state.n_events % MAX_EVENTS] = (
            state.active_start_buffcnt, int(buffcnt[-1]),
            state.active_start_t, float(time_s[-1]))
        state = state._replace(events=events, n_events=state.n_events + 1)
    cols = list(zip(*rows)) if rows else [()] * 6
    trace = DetectorTrace(
        *(np.asarray(c, dtype=bool) for c in cols[:5]),
        median_cn0=np.asarray(cols[5], dtype=np.float32))
    return state, trace


def events_to_list(state: DetectorState) -> list[dict]:
    """The padded event table as worker.py:449-455-style records, rows 0 to
    min(n_events, MAX_EVENTS) - 1 in row order."""
    out = []
    for i in range(min(int(state.n_events), MAX_EVENTS)):
        s_b, e_b, t0, t1 = state.events[i]
        out.append({
            "start_sample": int(s_b), "end_sample": int(e_b),
            "start_time": float(t0), "end_time": float(t1),
            "duration": float(t1 - t0),
        })
    return out
