"""GPS L1 C/A baseband synthesis for fixtures (counterpart of
gps_jamming_tpu.sim.gps).

Stands in for the reference's external `gps-sdr-sim` (README.md:40-47) in
tests: complex baseband holding C/A signals with a chosen code phase,
Doppler, carrier phase, nav bits and amplitude, plus AWGN from a seeded
torch.Generator, on `device` (None: the card). The signal is float32 in
the JAX package's operation order (t = arange(n)/fs exactly, see
`codes.sample_times`); past 2^24 samples t is as coarse as the
reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from ..device import as_device
from ..ops import codes as codes_ops
from ..utils import constants as C
from .jammers import make_generator


@dataclasses.dataclass(frozen=True)
class SatelliteSignal:
    """One simulated satellite signal."""
    prn: int
    doppler_hz: float = 0.0
    code_phase_chips: float = 0.0      # initial code phase offset
    carrier_phase_rad: float = 0.0
    amplitude: float = 1.0
    nav_bits: tuple = ()               # +/-1 bits; empty = none
    bit_periods: int = 20              # code periods per data bit/symbol
    #   20 = GPS LNAV 50 bps; 2 = SBAS 500 sps symbols (PRN >= 120 selects
    #   the SBAS C/A-family code automatically)


def _f32(v: float, dev) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=dev)


def ca_baseband(sat: SatelliteSignal, n_samples: int, sample_rate: float,
                device=None) -> torch.Tensor:
    """Complex64 baseband of one satellite. Code Doppler is carrier-aided:
    fcode = chip_rate * (1 + fd/fL1), as the tracking loop assumes
    (sdrtrk.c:105-107)."""
    dev = as_device(device)
    code = torch.from_numpy(
        codes_ops.sbas_ca_code(sat.prn) if sat.prn >= 120
        else codes_ops.gps_ca_code(sat.prn)).to(torch.float32).to(dev)
    fcode = C.GPS_CA_CHIP_RATE_HZ * (1.0 + sat.doppler_hz / C.GPS_L1_FREQ_HZ)
    chips = codes_ops.resample_code(code, fcode, sample_rate, n_samples,
                                    rem_chips=sat.code_phase_chips)
    t = codes_ops.sample_times(n_samples, sample_rate, dev)
    phase = 2.0 * math.pi * sat.doppler_hz * t + sat.carrier_phase_rad
    carrier = torch.complex(torch.cos(phase), torch.sin(phase))
    if sat.nav_bits:
        bits = torch.tensor(sat.nav_bits, dtype=torch.float32, device=dev)
        # which bit is each sample in (bit_periods code periods per bit)
        chips_elapsed = sat.code_phase_chips + t * fcode
        bit_idx = torch.floor(chips_elapsed / _f32(
            float(sat.bit_periods) * C.GPS_CA_CODE_LEN, dev)).to(torch.int64)
        data = bits[torch.clamp(bit_idx, 0, len(sat.nav_bits) - 1)]
    else:
        data = 1.0
    return sat.amplitude * chips * data * carrier


def scene(sats: Sequence[SatelliteSignal], n_samples: int,
          sample_rate: float, noise_std: float = 0.0,
          generator: torch.Generator | None = None,
          device=None) -> torch.Tensor:
    """Sum of satellite signals + complex AWGN (default generator seed 0
    on `device`)."""
    dev = as_device(device)
    out = torch.zeros(n_samples, dtype=torch.complex64, device=dev)
    for sat in sats:
        out = out + ca_baseband(sat, n_samples, sample_rate, dev)
    if noise_std > 0.0:
        g = generator or make_generator(0, dev)
        re = torch.randn(n_samples, generator=g, dtype=torch.float32,
                         device=dev)
        im = torch.randn(n_samples, generator=g, dtype=torch.float32,
                         device=dev)
        out = out + torch.complex(noise_std * re, noise_std * im)
    return out
