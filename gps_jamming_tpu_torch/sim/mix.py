"""Signal mixing (counterpart of gps_jamming_tpu.sim.mix): weaken GPS,
inject distance-scaled jammers, the spoofer mix.

The reference's mixer scripts:
- `weaken_gps.py:4-32`          : x0.125 + AWGN sigma=6.25 + clip + uint8
- `add_jammer_and_mix.py:26-181`: distance-scaled jammer injection with a
  static delay/duration window or a per-trajectory linearly interpolated
  power profile
- `spoofer_mixer.py:29-171`     : legit + spoof mix with a ramp-up envelope

All in the centered-float domain ([-128, 127.x]), complex64 tensors; use
ops.iq.write_iq_file to serialize to RTL-SDR uint8. The noise draws from
a torch.Generator on the signal's device, seeded from the integer the JAX
package gives jax.random.PRNGKey at the same place.
"""
from __future__ import annotations

import torch

from ..ops.codes import sample_times
from .jammers import make_generator


def _awgn(n: int, noise_std: float, generator: torch.Generator
          ) -> torch.Tensor:
    """Complex white noise of noise_std per component (I first, then Q)."""
    dev = generator.device
    re = torch.randn(n, generator=generator, dtype=torch.float32, device=dev)
    im = torch.randn(n, generator=generator, dtype=torch.float32, device=dev)
    return torch.complex(noise_std * re, noise_std * im)


def weaken(signal: torch.Tensor, scale: float = 0.125,
           noise_std: float = 6.25,
           generator: torch.Generator | None = None) -> torch.Tensor:
    """GPS weakening: scale + AWGN per component (weaken_gps.py:20-27);
    default generator seed 0."""
    out = signal * scale
    if noise_std > 0:
        g = generator or make_generator(0, signal.device)
        out = out + _awgn(signal.shape[-1], noise_std, g)
    return out


def distance_power_scale(distance_m, max_range_m: float,
                         jammer_power: float = 0.605) -> torch.Tensor:
    """Amplitude scale vs distance (add_jammer_and_mix.py:86-95), float32:
    P inside max_range/2, P*(ref/d) between ref and max_range, 0 beyond."""
    ref = max_range_m * 0.5
    d = distance_m if isinstance(distance_m, torch.Tensor) else \
        torch.as_tensor(distance_m, dtype=torch.float32)
    # tensor / tensor: `float / tensor` is a reciprocal times the float
    dc = torch.clamp(d, min=1e-9)
    far = torch.full_like(dc, jammer_power * ref) / dc
    scale = torch.where(d < ref, torch.full_like(far, jammer_power), far)
    return torch.where(d > max_range_m, torch.zeros_like(scale), scale)


def inject_static(gps: torch.Tensor, jammer: torch.Tensor,
                  sample_rate: float, delay_s: float, duration_s: float,
                  power_scale) -> torch.Tensor:
    """Static-mode injection window (add_jammer_and_mix.py:158-172): adds
    power_scale * jammer into gps over [delay, delay + duration) seconds,
    the jammer starting at its own sample 0 when the gate opens.

    As the JAX package: the gate's bounds are float32, so the sample
    index is compared in float32 (coarse past 2^24), and the roll is
    delay_s * fs truncated to an integer."""
    n = gps.shape[-1]
    idx = torch.arange(n, device=gps.device).to(torch.float32)
    start = torch.tensor(delay_s * sample_rate, dtype=torch.float32,
                         device=gps.device)
    stop = torch.tensor((delay_s + duration_s) * sample_rate,
                        dtype=torch.float32, device=gps.device)
    gate = ((idx >= start) & (idx < stop)).to(torch.float32)
    shifted = torch.roll(jammer, int(delay_s * sample_rate), dims=-1)
    return gps + gate * power_scale * shifted


def inject_profile(gps: torch.Tensor, jammer: torch.Tensor,
                   power_profile: torch.Tensor) -> torch.Tensor:
    """Dynamic-mode injection: per-sample amplitude profile
    (add_jammer_and_mix.py:100-135, linear interpolation upstream)."""
    return gps + power_profile * jammer


def trajectory_power_profile(distances_m: torch.Tensor,
                             samples_per_step: int, max_range_m: float,
                             jammer_power: float = 0.605) -> torch.Tensor:
    """Per-sample power profile from per-timestep jammer distances: linear
    interpolation between steps, then a constant last step
    (add_jammer_and_mix.py:107-135)."""
    p = distance_power_scale(distances_m, max_range_m, jammer_power)
    frac = torch.arange(samples_per_step, dtype=torch.float32,
                        device=p.device) / torch.full(
        (), samples_per_step, dtype=torch.float32, device=p.device)
    segs = p[:-1, None] + (p[1:, None] - p[:-1, None]) * frac[None, :]
    tail = p[-1:, None].expand(1, samples_per_step)
    return torch.cat([segs, tail], dim=0).reshape(-1)


def spoof_mix(legit: torch.Tensor, spoof: torch.Tensor, sample_rate: float,
              start_s: float, ramp_s: float,
              overpower: float = 2.0) -> torch.Tensor:
    """Spoofing mix with a ramp-up envelope (spoofer_mixer.py:29-171): the
    spoof fades in linearly over ramp_s from start_s and holds at
    `overpower` relative amplitude."""
    t = sample_times(legit.shape[-1], sample_rate, legit.device)
    ramp = torch.full((), max(ramp_s, 1e-9), dtype=torch.float32,
                      device=legit.device)
    env = torch.clamp((t - start_s) / ramp, 0.0, 1.0)
    return legit + overpower * env * spoof


def finalize_uint8_domain(x: torch.Tensor, noise_std: float = 0.0,
                          generator: torch.Generator | None = None
                          ) -> torch.Tensor:
    """Optional AWGN, then clip to the uint8-representable centered range
    (default generator seed 1)."""
    if noise_std > 0:
        g = generator or make_generator(1, x.device)
        x = x + _awgn(x.shape[-1], noise_std, g)
    return torch.complex(torch.clamp(x.real, -128.0, 127.0),
                         torch.clamp(x.imag, -128.0, 127.0))
