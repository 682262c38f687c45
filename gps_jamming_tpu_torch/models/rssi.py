"""RSSI path-loss ranging and grid-search jammer localization (counterpart
of gps_jamming_tpu.models.rssi).

`skrypty/triangulateRSSI.py` (+ the heatmap variant
`triangulateRSSIplot.py` and the single-antenna `CalculateDistance.py`):

- per-antenna ranging: turn-on detection -> mean amplitude -> received
  power -> log-distance inversion (triangulateRSSI.py:54-82), on the
  device;
- localization: the 300 x 300 error surface of the grid search (:88-120)
  as one broadcast on the device, the lowest flat index winning ties;
- heatmap variant: the error surface and the top-k distinct minima >= 5 m
  apart (triangulateRSSIplot.py:64-133), k rounds of greedy suppression
  over one device tensor.

Geo conversion uses ops.geodesy.meters_to_degrees (111320 m/deg contract).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..config import RssiConfig
from ..device import as_device, on_device
from ..ops import geodesy, pathloss
from ..ops import iq as iq_ops
from ..ops import power as power_ops

DEFAULT_POSITIONS = [(0.0, 0.0), (0.5, 0.0), (0.0, 0.5)]


class RangingResult(NamedTuple):
    distance_m: torch.Tensor       # estimated distance; NaN when no signal
    received_db: torch.Tensor
    mean_amplitude: torch.Tensor
    onset_index: torch.Tensor      # -1 when below threshold everywhere


def range_from_iq(iq_normalized, cfg: RssiConfig,
                  device=None) -> RangingResult:
    """Distance estimate from one antenna's normalized [-1, 1] I/Q capture
    (calculate_distance_from_file, triangulateRSSI.py:54-82): the first
    amplitude above the threshold marks the turn-on, the mean amplitude
    from there on gives Prx = 10 log10(amp^2), and the log-distance model
    inverts it.

    iq_normalized: complex64 tensor (keeps its device) or array (sent to
    `device`, None: the card).
    """
    x = on_device(iq_normalized, device)
    amp = torch.sqrt(x.real * x.real + x.imag * x.imag)
    onset = power_ops.find_first_above(amp, cfg.signal_threshold)
    mean_amp = power_ops.mean_after_onset(amp, onset)
    prx = pathloss.received_power_db(mean_amp.clamp(min=1e-12))
    dist = pathloss.invert_distance_m(prx, cfg.tx_power_dbm,
                                      cfg.path_loss_exponent,
                                      cfg.frequency_mhz)
    dist = torch.where(onset < 0, torch.full_like(dist, float("nan")), dist)
    return RangingResult(dist, prx, mean_amp, onset)


def range_from_file(path: str, cfg: RssiConfig,
                    chunk_samples: int = 1 << 21) -> float:
    """Bounded-memory twin of `range_from_iq` for a capture FILE, host
    NumPy as in the JAX package.

    Streams the normalized amplitude in chunks (host memory = one chunk,
    ~16 MB), finds the turn-on sample and accumulates the post-onset mean
    amplitude in float64. Returns the distance in meters (NaN when the
    threshold is never crossed).
    """
    onset = -1
    amp_sum = 0.0
    amp_cnt = 0
    g0 = 0
    while True:
        x = iq_ops.read_iq_file(path, convention="normalized",
                                count=2 * chunk_samples,
                                offset_bytes=2 * g0)
        if x.size == 0:
            break
        amp = np.abs(x).astype(np.float32)
        if onset < 0:
            above = amp > cfg.signal_threshold
            if above.any():
                i = int(np.argmax(above))
                onset = g0 + i
                amp_sum += float(np.sum(amp[i:], dtype=np.float64))
                amp_cnt += amp.size - i
        else:
            amp_sum += float(np.sum(amp, dtype=np.float64))
            amp_cnt += amp.size
        g0 += x.size
    if onset < 0 or amp_cnt == 0:
        return float("nan")
    mean_amp = max(amp_sum / amp_cnt, 1e-12)
    prx = float(pathloss.received_power_db(np.float32(mean_amp)))
    return float(pathloss.invert_distance_m(
        prx, cfg.tx_power_dbm, cfg.path_loss_exponent, cfg.frequency_mhz))


def error_surface(positions: torch.Tensor, radii: torch.Tensor,
                  grid_density: int, range_multiplier: float):
    """Sum-abs-error surface over the search grid (triangulateRSSI.py:88-114).

    positions: (n_ant, 2), radii: (n_ant,), float32 on one device. The grid
    spans center +/- range_multiplier * max_r. Returns (err (g, g), grid_x
    (g,), grid_y (g,)); x varies along axis 1.
    """
    span = radii.max() * range_multiplier
    center = positions.mean(dim=0)
    lo, hi = (center - span).tolist(), (center + span).tolist()
    kw = dict(dtype=torch.float32, device=positions.device)
    xs = torch.linspace(lo[0], hi[0], grid_density, **kw)
    ys = torch.linspace(lo[1], hi[1], grid_density, **kw)
    d = torch.sqrt((xs[None, :, None] - positions[:, 0]) ** 2
                   + (ys[:, None, None] - positions[:, 1]) ** 2)
    return (d - radii).abs().sum(dim=-1), xs, ys


def grid_search(positions: torch.Tensor, radii: torch.Tensor,
                grid_density: int = 300,
                range_multiplier: float = 1.5) -> torch.Tensor:
    """Best (x, y) by minimum total absolute error (perform_grid_search);
    the lowest flat index wins ties."""
    err, xs, ys = error_surface(positions, radii, grid_density,
                                range_multiplier)
    idx = err.reshape(-1).argmin()
    return torch.stack([xs[idx % grid_density], ys[idx // grid_density]])


def top_k_minima(err: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                 k: int = 8, min_separation_m: float = 5.0):
    """Top-k distinct minima of the error surface, >= min_separation apart
    (triangulateRSSIplot.py:64-99), by k rounds of greedy suppression on
    the device: each round takes the lowest remaining point and masks
    everything within min_separation of it, so round n yields the n-th
    pick of the reference's sorted-candidate scan. Rounds that found no
    finite point are trimmed. Returns NumPy (picked (n, 2), errors (n,))."""
    g = err.shape[0]
    flat = err.reshape(-1).to(torch.float32)
    cx = xs.to(torch.float32).repeat(g)               # flat idx = iy * g + ix
    cy = ys.to(torch.float32).repeat_interleave(g)
    sep2 = np.float32(min_separation_m) ** 2
    picks = []
    for _ in range(k):
        i = flat.argmin()
        px, py = cx[i], cy[i]
        picks.append(torch.stack([px, py, flat[i]]))
        kill = (cx - px) ** 2 + (cy - py) ** 2 < sep2
        flat = flat.masked_fill(kill, float("inf"))
    out = torch.stack(picks).cpu().numpy()
    n = int(np.sum(np.isfinite(out[:, 2])))
    return out[:n, :2], out[:n, 2]


def _failure(message: str, n_antennas: int, distances=None) -> dict:
    return {"success": False, "distances": distances,
            "location_meters": None, "location_geographic": None,
            "message": message, "num_antennas": n_antennas}


def triangulate(file_iqs: Sequence, antenna_positions_m: Sequence,
                reference_lat: float = 50.00898,
                reference_lon: float = 19.98287,
                cfg: RssiConfig = RssiConfig(), device=None) -> dict:
    """Full localization; the result dict mirrors
    triangulate_jammer_location (triangulateRSSI.py:126-229).

    file_iqs: per-antenna complex captures in the NORMALIZED convention,
    tensors (kept on their device) or arrays, which go to `device` (None:
    the card) one antenna at a time.
    """
    if antenna_positions_m is None:
        antenna_positions_m = DEFAULT_POSITIONS[:len(file_iqs)]
    if len(file_iqs) < 2:
        return _failure("At least 2 antenna captures are required.",
                        len(file_iqs))
    distances = []
    for x in file_iqs:
        d = float(range_from_iq(x, cfg, device).distance_m)
        distances.append(None if np.isnan(d) else d)
    return _localize_from_distances(distances, antenna_positions_m,
                                    reference_lat, reference_lon, cfg,
                                    len(file_iqs), device)


def triangulate_files(paths: Sequence[str], antenna_positions_m: Sequence,
                      reference_lat: float = 50.00898,
                      reference_lon: float = 19.98287,
                      cfg: RssiConfig = RssiConfig(), device=None) -> dict:
    """`triangulate` fed by streamed per-file ranging (bounded host
    memory); the grid search runs on `device` (None: the card)."""
    if antenna_positions_m is None:
        antenna_positions_m = DEFAULT_POSITIONS[:len(paths)]
    if len(paths) < 2:
        return _failure("At least 2 antenna captures are required.",
                        len(paths))
    distances = []
    for p in paths:
        d = range_from_file(p, cfg)
        distances.append(None if np.isnan(d) else d)
    return _localize_from_distances(distances, antenna_positions_m,
                                    reference_lat, reference_lon, cfg,
                                    len(paths), device)


def _localize_from_distances(distances, antenna_positions_m,
                             reference_lat, reference_lon, cfg,
                             n_antennas: int, device=None) -> dict:
    valid_pos, valid_r = [], []
    for i, d in enumerate(distances):
        if d is not None and i < len(antenna_positions_m):
            valid_pos.append(antenna_positions_m[i])
            valid_r.append(d)
    if len(valid_r) < 2:
        return _failure(
            f"Ranging succeeded on only {len(valid_r)} antennas (min 2).",
            n_antennas, distances)
    dev = as_device(device)
    best = grid_search(
        torch.tensor(valid_pos, dtype=torch.float32, device=dev),
        torch.tensor(valid_r, dtype=torch.float32, device=dev),
        grid_density=cfg.grid_density,
        range_multiplier=cfg.search_range_multiplier).tolist()
    bx, by = float(best[0]), float(best[1])
    dlat, dlon = geodesy.meters_to_degrees(bx, by, reference_lat)
    dlat, dlon = float(dlat), float(dlon)
    return {
        "success": True,
        "distances": distances,
        "location_meters": [bx, by],
        "location_geographic": {
            "lat": reference_lat + dlat,
            "lon": reference_lon + dlon,
            "lat_offset_degrees": dlat,
            "lon_offset_degrees": dlon,
            "lat_offset_minutes": dlat * 60,
            "lon_offset_minutes": dlon * 60,
        },
        "message": f"Grid-search localization x={bx:.2f}m, y={by:.2f}m",
        "num_antennas": len(valid_r),
    }
