"""Jammer waveform generators (counterpart of gps_jamming_tpu.sim.jammers).

The reference's four GNU Radio flowgraphs
(`simulate/frontend/jammers/{cw,chirp,broadband,pulsed}Jammer.py`) as
torch functions: complex64 baseband at the capture rate, unit amplitude
(the mixer scales, sim/mix.py), on `device` (None: the card).

- CW       : complex exponential at a fixed offset (cwJammer.py:50).
- chirp    : sawtooth-driven VCO sweeping a band (chirpJammer.py:45-59).
- broadband: complex white Gaussian noise (broadbandJammer.py:50).
- pulsed   : CW gated by a square wave at the PRF (pulsedJammer.py:47-53).

The deterministic kinds compute in float32 with the JAX package's
operation order: t = arange(n)/fs exactly (`codes.sample_times`), the
sawtooth and the gate by fmod, which is exact (torch.remainder is not).
Past 2^24 samples t is as coarse as the reference's.
"""
from __future__ import annotations

import math

import torch

from ..device import as_device
from ..ops.codes import sample_times


def _expj(phase: torch.Tensor) -> torch.Tensor:
    return torch.complex(torch.cos(phase), torch.sin(phase))


def cw(n_samples: int, sample_rate: float, offset_hz: float = 100e3,
       amplitude: float = 1.0, device=None) -> torch.Tensor:
    """Continuous-wave tone at offset_hz from center."""
    t = sample_times(n_samples, sample_rate, as_device(device))
    return amplitude * _expj(2.0 * math.pi * offset_hz * t)


def chirp(n_samples: int, sample_rate: float, f_start_hz: float = -500e3,
          f_stop_hz: float = 500e3, sweep_period_s: float = 2.0,
          amplitude: float = 1.0, device=None) -> torch.Tensor:
    """Sawtooth-swept chirp: the frequency ramps f_start -> f_stop each
    period; per sweep of duration T the phase is
    2*pi*(f_start*tau + (f_stop - f_start)*tau^2/(2T))."""
    t = sample_times(n_samples, sample_rate, as_device(device))
    tau = torch.fmod(t, sweep_period_s)
    k = (f_stop_hz - f_start_hz) / sweep_period_s
    phase = 2.0 * math.pi * (f_start_hz * tau + 0.5 * k * tau * tau)
    return amplitude * _expj(phase)


def broadband(n_samples: int, generator: torch.Generator,
              amplitude: float = 1.0) -> torch.Tensor:
    """Complex white Gaussian noise, unit power per component, drawn from
    `generator` on its device (I first, then Q)."""
    dev = generator.device
    i = torch.randn(n_samples, generator=generator, dtype=torch.float32,
                    device=dev)
    q = torch.randn(n_samples, generator=generator, dtype=torch.float32,
                    device=dev)
    return amplitude * torch.complex(i, q)


def pulsed(n_samples: int, sample_rate: float, offset_hz: float = 100e3,
           prf_hz: float = 1000.0, duty: float = 0.5,
           amplitude: float = 1.0, device=None) -> torch.Tensor:
    """CW gated by a square wave at prf_hz (pulsedJammer.py:47-53)."""
    t = sample_times(n_samples, sample_rate, as_device(device))
    gate = (torch.fmod(t * prf_hz, 1.0) < duty).to(torch.float32)
    return amplitude * gate * _expj(2.0 * math.pi * offset_hz * t)


JAMMER_TYPES = ("cw", "chirp", "broadband", "pulsed")


def make_generator(seed: int, device=None) -> torch.Generator:
    """A torch.Generator on `device` (None: the card) seeded with `seed`,
    the integer the JAX package gives jax.random.PRNGKey at the same
    place."""
    g = torch.Generator(device=as_device(device))
    g.manual_seed(int(seed))
    return g


def generate(kind: str, n_samples: int, sample_rate: float,
             generator: torch.Generator | None = None, device=None,
             **kwargs) -> torch.Tensor:
    """Dispatch by jammer kind (the reference GUI's mode B selector).
    broadband draws from `generator` (default: seed 0 on `device`)."""
    if kind == "cw":
        return cw(n_samples, sample_rate, device=device, **kwargs)
    if kind == "chirp":
        return chirp(n_samples, sample_rate, device=device, **kwargs)
    if kind == "broadband":
        if generator is None:
            generator = make_generator(0, device)
        return broadband(n_samples, generator, **kwargs)
    if kind == "pulsed":
        return pulsed(n_samples, sample_rate, device=device, **kwargs)
    raise ValueError(f"unknown jammer kind {kind!r}; one of {JAMMER_TYPES}")
