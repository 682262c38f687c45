"""Log-distance path-loss model and inversion (counterpart of
gps_jamming_tpu.ops.pathloss).

The RSSI ranging math of `skrypty/triangulateRSSI.py:54-82` and
`skrypty/CalculateDistance.py:42-51`:
  PL(1m) = 20*log10(f_MHz) - 27.55
  d = 10^((Ptx - Prx - PL(1m)) / (10*n))

Float32, as the JAX package computes it: a tensor keeps its device and
dtype, and a Python number becomes a float32 tensor on the host.
"""
from __future__ import annotations

import torch


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        x, dtype=torch.float32)


def path_loss_at_1m_db(frequency_mhz) -> torch.Tensor:
    """Free-space path loss at 1 m for f in MHz (triangulateRSSI.py:74)."""
    return 20.0 * torch.log10(_t(frequency_mhz)) - 27.55


def received_power_db(mean_amplitude) -> torch.Tensor:
    """Prx = 10*log10(amplitude^2) in the digital scale (triangulateRSSI.py:70)."""
    return 10.0 * torch.log10(_t(mean_amplitude) ** 2)


def invert_distance_m(received_db, tx_power_dbm: float,
                      path_loss_exponent: float,
                      frequency_mhz: float) -> torch.Tensor:
    """Distance from received power via the log-distance model."""
    received_db = _t(received_db)
    pl1 = path_loss_at_1m_db(frequency_mhz).to(received_db.device)
    return 10.0 ** ((tx_power_dbm - received_db - pl1)
                    / (10.0 * path_loss_exponent))


def forward_received_db(distance_m, tx_power_dbm: float,
                        path_loss_exponent: float,
                        frequency_mhz: float) -> torch.Tensor:
    """Forward model (for simulation / tests): Prx at a given distance."""
    distance_m = _t(distance_m)
    pl1 = path_loss_at_1m_db(frequency_mhz).to(distance_m.device)
    return (tx_power_dbm - pl1
            - 10.0 * path_loss_exponent * torch.log10(distance_m))
