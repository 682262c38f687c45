"""GLONASS L1OF baseband simulation, FDMA channels and the 511-chip code
(counterpart of gps_jamming_tpu.sim.glo).

The simulator side of the GLONASS receiver (models.receiver.glonass): the
reference has none (gps-sdr-sim is GPS-only). complex64 on `device`
(None: the card), float32 in the JAX package's operation order.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..device import as_device
from ..ops import codes as codes_ops
from ..utils import constants as C
from .jammers import make_generator


@dataclasses.dataclass(frozen=True)
class GloSignal:
    freq_ch: int                  # FDMA frequency number (-7..6)
    doppler_hz: float = 0.0       # true Doppler on the channel carrier
    code_phase_chips: float = 0.0
    amplitude: float = 1.0
    symbols: tuple = ()           # 100 sps line symbols (0/1); empty = none


def baseband(sig: GloSignal, n_samples: int, sample_rate: float,
             center_freq_hz: float = C.GLO_G1_BASE_FREQ_HZ,
             device=None) -> torch.Tensor:
    """One GLONASS channel's complex baseband after the front end's mix
    down to `center_freq_hz`."""
    dev = as_device(device)
    code = torch.from_numpy(codes_ops.glonass_code()).to(torch.float32).to(
        dev)
    carrier_hz = codes_ops.glonass_carrier_hz(sig.freq_ch)
    offset = carrier_hz - center_freq_hz + sig.doppler_hz
    fcode = C.GLO_CHIP_RATE_HZ * (1.0 + sig.doppler_hz / carrier_hz)
    chips = codes_ops.resample_code(code, fcode, sample_rate, n_samples,
                                    rem_chips=sig.code_phase_chips)
    t = codes_ops.sample_times(n_samples, sample_rate, dev)
    theta = 2.0 * math.pi * offset * t
    if sig.symbols:
        sym = torch.tensor(sig.symbols, dtype=torch.float32,
                           device=dev) * -2.0 + 1.0           # 0 -> +1
        # 100 sps = 10 ms per symbol = 10 code periods
        chips_elapsed = sig.code_phase_chips + t * fcode
        idx = torch.floor(chips_elapsed / torch.full(
            (), 10.0 * C.GLO_CODE_LEN, dtype=torch.float32, device=dev)
        ).to(torch.int64)
        data = sym[torch.clamp(idx, 0, len(sig.symbols) - 1)]
    else:
        data = 1.0
    s = sig.amplitude * chips * data
    return torch.complex(torch.cos(theta) * s, torch.sin(theta) * s)


def scene(signals, n_samples: int, sample_rate: float,
          center_freq_hz: float = C.GLO_G1_BASE_FREQ_HZ,
          noise_std: float = 0.0,
          generator: torch.Generator | None = None,
          device=None) -> torch.Tensor:
    """Sum of channels + complex AWGN (default generator seed 0)."""
    dev = as_device(device)
    out = torch.zeros(n_samples, dtype=torch.complex64, device=dev)
    for s in signals:
        out = out + baseband(s, n_samples, sample_rate, center_freq_hz, dev)
    if noise_std > 0.0:
        g = generator or make_generator(0, dev)
        re = torch.randn(n_samples, generator=g, dtype=torch.float32,
                         device=dev)
        im = torch.randn(n_samples, generator=g, dtype=torch.float32,
                         device=dev)
        out = out + torch.complex(noise_std * re, noise_std * im)
    return out
