"""TDOA jammer localization: onset sync, cross-correlation, lag -> AoA, and
a multi-pair hyperbolic grid fix (counterpart of
gps_jamming_tpu.models.tdoa).

`skrypty/triangulateTDOA.py`:
- coarse sync by interference onset (:37-49), `ops.power.find_onset` on
  the device;
- cross-correlation of the aligned slices (:80-89) for every antenna pair
  at once, torch.fft on the device;
- lag -> TDOA -> path difference -> two candidate azimuths (:92-127).

Beyond the reference, as in the JAX package: the parabolic sub-sample
peak, the baseline angle atan2(dy, dx) (the reference's atan2(dy, x0-x0)
puts every baseline at +/-90 deg), and N-antenna pairs with a hyperbolic
grid fix.
"""
from __future__ import annotations

import itertools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..config import TdoaConfig
from ..device import as_device, on_device
from ..ops import corr as corr_ops
from ..ops import iq as iq_ops
from ..ops import power as power_ops
from ..utils import constants as C


class PairTdoa(NamedTuple):
    pair: tuple               # (i, j) antenna indices
    lag_samples: float        # signal_j relative to signal_i (j later > 0)
    tdoa_s: float
    path_difference_m: float
    peak_magnitude: float


def aligned_slices(iq_list: Sequence, cfg: TdoaConfig, device=None):
    """Onset-align each capture and cut the correlation slice
    (triangulateTDOA.py:60-83). Returns (slices (n, L) complex64 on the
    device, onsets list); raises ValueError when an onset is undetectable
    or the slice would run past the end. Captures are tensors (kept on
    their device) or arrays, which go to `device` (None: the card) one at a
    time."""
    L = cfg.correlation_slice_size
    slices, starts = [], []
    for x in iq_list:
        x = on_device(x, device)
        s = int(power_ops.find_onset(x, cfg.noise_sample_size,
                                     cfg.detection_window_size,
                                     cfg.detection_threshold_factor))
        if s < 0:
            raise ValueError("interference onset not detected")
        if x.shape[-1] < s + L:
            raise ValueError("not enough samples after onset for the slice")
        slices.append(x[s:s + L].clone())
        starts.append(s)
    return torch.stack(slices), starts


def pair_lags(slices: torch.Tensor, cfg: TdoaConfig) -> torch.Tensor:
    """Cross-correlation peak lag for every antenna pair, batched.

    slices: (n_ant, L). Returns (n_pairs,) float32 lags for the pairs in
    itertools.combinations order, each correlate(sig_j, sig_i) as the
    reference's correlate(signal1, signal0).
    """
    pairs = list(itertools.combinations(range(slices.shape[0]), 2))
    a = slices[[j for _, j in pairs]]
    b = slices[[i for i, _ in pairs]]
    lag, _ = corr_ops.xcorr_peak_lag(a, b, subsample=cfg.subsample_interp)
    return lag


def bearing_from_lag(lag_samples: float, sample_rate: float,
                     ant_i_pos, ant_j_pos) -> dict:
    """Lag -> TDOA -> path difference -> two candidate azimuths
    (triangulateTDOA.py:92-127, with the baseline angle fixed). Host
    float64."""
    tdoa = lag_samples / sample_rate
    path_diff = tdoa * C.SPEED_OF_LIGHT
    pi = np.asarray(ant_i_pos, dtype=np.float64)
    pj = np.asarray(ant_j_pos, dtype=np.float64)
    baseline = float(np.linalg.norm(pj - pi))
    out = {"tdoa_s": float(tdoa), "path_difference_m": float(path_diff),
           "baseline_m": baseline, "valid": False,
           "theta_deg": None, "azimuths_deg": None}
    if baseline == 0.0:
        return out
    cos_arg = path_diff / baseline
    if abs(cos_arg) > 1.0:
        return out   # reference warns: likely config error or multipath
    theta = float(np.degrees(np.arccos(cos_arg)))
    base_ang = float(np.degrees(np.arctan2(pj[1] - pi[1], pj[0] - pi[0])))
    out.update(valid=True, theta_deg=theta,
               azimuths_deg=((base_ang + theta) % 360.0,
                             (base_ang - theta) % 360.0))
    return out


def hyperbolic_grid_fix(antenna_positions_m: Sequence, pair_ids: Sequence,
                        path_diffs_m: Sequence, span_m: float = 50.0,
                        density: int = 512, device=None) -> np.ndarray:
    """Least-squares source position from pairwise path differences: a grid
    search on `device` (None: the card) minimizing the sum over pairs of
    | (|p - ant_j| - |p - ant_i|) - measured_path_diff |, the lowest flat
    index winning ties. Returns NumPy (2,) float32."""
    pos = torch.tensor(antenna_positions_m, dtype=torch.float32,
                       device=as_device(device))
    lo, hi = (pos.mean(dim=0) - span_m).tolist(), \
        (pos.mean(dim=0) + span_m).tolist()
    kw = dict(dtype=torch.float32, device=pos.device)
    xs = torch.linspace(lo[0], hi[0], density, **kw)
    ys = torch.linspace(lo[1], hi[1], density, **kw)
    d = torch.sqrt((xs[None, :, None] - pos[:, 0]) ** 2
                   + (ys[:, None, None] - pos[:, 1]) ** 2)   # (g, g, n_ant)
    err = torch.zeros(d.shape[:2], **kw)
    for (i, j), pd in zip(pair_ids, path_diffs_m):
        err = err + ((d[..., j] - d[..., i]) - pd).abs()
    idx = err.reshape(-1).argmin()
    return torch.stack([xs[idx % density], ys[idx // density]]).cpu().numpy()


def file_onset(path: str, cfg: TdoaConfig,
               chunk_samples: int = 1 << 21) -> int:
    """Bounded-memory interference-onset search over a capture FILE, host
    NumPy as in the JAX package.

    The detection contract of ops.power.find_onset (triangulateTDOA.py:
    37-49), with the streamed moving average accumulated in float64: on
    multi-minute captures, where find_onset's float32 cumsum loses
    precision, this is the more accurate of the two, and a near-threshold
    crossing can differ by a sample. noise floor = mean power of the first
    noise_sample_size samples; onset = first index whose window moving
    average exceeds factor * floor, recentred by window//2; -1 when never
    crossed. Host memory = one chunk (+ the window carry)."""
    x0 = iq_ops.read_iq_file(path, convention="centered",
                             count=2 * cfg.noise_sample_size)
    if x0.size == 0:
        return -1
    p0 = (x0.real.astype(np.float32) ** 2 + x0.imag.astype(np.float32) ** 2)
    noise = float(np.mean(p0)) or 1e-9
    thr = noise * cfg.detection_threshold_factor
    w = cfg.detection_window_size

    carry = np.zeros(0, np.float64)
    g0 = 0                                # global index of carry[0]
    read_at = 0
    while True:
        x = iq_ops.read_iq_file(path, convention="centered",
                                count=2 * chunk_samples,
                                offset_bytes=2 * read_at)
        if x.size == 0:
            return -1
        read_at += x.size
        pw = (x.real.astype(np.float32) ** 2
              + x.imag.astype(np.float32) ** 2).astype(np.float64)
        seq = np.concatenate([carry, pw])
        if seq.size >= w:
            c = np.concatenate([[0.0], np.cumsum(seq)])
            avg = (c[w:] - c[:-w]) / w
            above = avg > thr
            if above.any():
                return g0 + int(np.argmax(above)) + w // 2
            keep = w - 1
            g0 += seq.size - keep
            carry = seq[-keep:]
        else:
            carry = seq


def localize_files(paths: Sequence[str], antenna_positions_m: Sequence,
                   sample_rate: float, cfg: TdoaConfig = TdoaConfig(),
                   device=None) -> dict:
    """`localize` fed from capture FILES with bounded host memory: the
    onset scan streams chunks on the host, and only the correlation slices
    (50 000 samples each, triangulateTDOA.py:80-83) are read in full and go
    to `device` (None: the card)."""
    starts = []
    slices_np = []
    L = cfg.correlation_slice_size
    for p in paths:
        s0 = file_onset(p, cfg)
        if s0 < 0:
            raise ValueError("interference onset not detected")
        sl = iq_ops.read_iq_file(p, convention="centered",
                                 count=2 * L, offset_bytes=2 * s0)
        if sl.size < L:
            raise ValueError("not enough samples after onset for the slice")
        starts.append(s0)
        slices_np.append(sl)
    slices = torch.from_numpy(np.stack(slices_np)).to(as_device(device))
    return _localize_from_slices(slices, starts, len(paths),
                                 antenna_positions_m, sample_rate, cfg)


def localize(iq_list: Sequence, antenna_positions_m: Sequence,
             sample_rate: float, cfg: TdoaConfig = TdoaConfig(),
             device=None) -> dict:
    """The TDOA pipeline over N >= 2 antennas: per-pair results
    (reference-compatible bearings) plus, with N >= 3, a hyperbolic grid
    position fix. Captures as `aligned_slices` takes them."""
    slices, onsets = aligned_slices(iq_list, cfg, device)
    return _localize_from_slices(slices, onsets, len(iq_list),
                                 antenna_positions_m, sample_rate, cfg)


def _localize_from_slices(slices, onsets, n_ant, antenna_positions_m,
                          sample_rate, cfg) -> dict:
    lags = pair_lags(slices, cfg).cpu().numpy()
    pairs = list(itertools.combinations(range(n_ant), 2))
    results = []
    path_diffs = []
    for (i, j), lag in zip(pairs, lags):
        r = bearing_from_lag(float(lag), sample_rate,
                             antenna_positions_m[i], antenna_positions_m[j])
        r["pair"] = (i, j)
        r["lag_samples"] = float(lag)
        results.append(r)
        path_diffs.append(r["path_difference_m"])
    out = {"onsets": onsets, "pairs": results, "position_m": None}
    if n_ant >= 3:
        fix = hyperbolic_grid_fix(antenna_positions_m, pairs, path_diffs,
                                  device=slices.device)
        out["position_m"] = [float(fix[0]), float(fix[1])]
    return out
