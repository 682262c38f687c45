"""Receiver trajectory generation (NumPy copy of
gps_jamming_tpu.sim.trajectory).

`simulate/frontend/generate_trajectory.py:22-58`: linear LLA
interpolation sampled at 10 Hz, emitted as (time, x, y, z) ECEF rows in
gps-sdr-sim's `-u` user-motion CSV format.
"""
from __future__ import annotations

import numpy as np

from ..models.receiver import pvt


def linear_trajectory(start_lla, end_lla, duration_s: float,
                      rate_hz: float = 10.0) -> np.ndarray:
    """Rows (t, x, y, z): a linear LLA sweep converted to ECEF in float64
    (the float32 geodesy ops quantize ECEF at ~0.4 m, too coarse for
    carrier-phase-level rendering)."""
    n = max(int(np.ceil(duration_s * rate_hz)) + 1, 2)
    f = np.linspace(0.0, 1.0, n)
    lat = start_lla[0] + (end_lla[0] - start_lla[0]) * f
    lon = start_lla[1] + (end_lla[1] - start_lla[1]) * f
    alt = start_lla[2] + (end_lla[2] - start_lla[2]) * f
    xyz = pvt.lla_to_ecef(lat, lon, alt)                    # (n, 3) float64
    t = np.linspace(0.0, duration_s, n)
    return np.concatenate([t[:, None], xyz], axis=1)


def write_user_motion_csv(path: str, rows: np.ndarray) -> None:
    """gps-sdr-sim -u format: time,x,y,z with 1 decimal place times."""
    with open(path, "w") as f:
        for t, x, y, z in rows:
            f.write(f"{t:.1f},{x:.3f},{y:.3f},{z:.3f}\n")


def jammer_distances(rows: np.ndarray, jammer_lla) -> np.ndarray:
    """Per-timestep receiver->jammer distance (add_jammer_and_mix.py:79-88)."""
    d = rows[:, 1:4] - pvt.lla_to_ecef(*jammer_lla)
    return np.sqrt((d ** 2).sum(axis=1))
