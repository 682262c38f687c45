"""Scenarios: jammed, clean and spoofed captures with known ground truth
(counterpart of gps_jamming_tpu.sim.scenario).

The library version of the reference's gps-sdr-sim + jammer + mixer
subprocess chain (gnss_frontend.py:955-1070): multi-antenna RTL-SDR
captures of a jamming scenario with a known jammer position, power and
timing, rendered on `device` (None: the card) and written as uint8 `.bin`
files, the bytes converted on the device (`iq.write_iq_file`).

Random draws come from torch.Generators seeded with the integers the JAX
package gives jax.random.PRNGKey at the same place (seed*1000 + antenna
for the jammer and the noise of each antenna, one generator drawn in that
order, so every antenna's streams differ); jax.random's streams are not
reproduced, only their distribution.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..device import as_device
from ..ops import iq as iq_ops
from ..ops import pathloss
from ..utils import constants as C
from . import jammers, mix


@dataclasses.dataclass(frozen=True)
class JammerScenario:
    """Ground truth of a simulated jamming event."""
    kind: str = "cw"                     # cw | chirp | broadband | pulsed
    position_m: tuple = (10.0, 5.0)      # east/north meters from antenna 0
    tx_power_dbm: float = 40.0
    path_loss_exponent: float = 3.0
    frequency_mhz: float = 1575.42
    start_s: float = 2.0
    duration_s: float = 3.0
    seed: int = 0


def antenna_distances(scn: JammerScenario,
                      antenna_positions_m: Sequence) -> np.ndarray:
    pos = np.asarray(antenna_positions_m, dtype=np.float64)
    jam = np.asarray(scn.position_m, dtype=np.float64)
    return np.sqrt(((pos - jam) ** 2).sum(axis=1))


def jammer_amplitude_at(scn: JammerScenario, distance_m: float) -> float:
    """Digital amplitude that the RSSI inversion maps back to distance_m.

    The RSSI localizer assumes Prx = 10*log10(mean_amplitude^2) in the
    normalized [-1, 1] domain (triangulateRSSI.py:68-75); the centered
    uint8 domain is 127.5x larger."""
    prx_db = pathloss.forward_received_db(
        distance_m, scn.tx_power_dbm, scn.path_loss_exponent,
        scn.frequency_mhz)
    amp_normalized = 10.0 ** (float(prx_db) / 20.0)
    return amp_normalized * 127.5


def _background(background, n_samples: int, dev) -> torch.Tensor:
    if background is None:
        return torch.zeros(n_samples, dtype=torch.complex64, device=dev)
    if isinstance(background, torch.Tensor):
        return background.to(dev)
    return torch.from_numpy(np.ascontiguousarray(
        background, dtype=np.complex64)).to(dev)


def render_antenna_capture(scn: JammerScenario, antenna_pos_m,
                           n_samples: int, sample_rate: float,
                           noise_std: float = 6.25, background=None,
                           antenna_index: int = 0,
                           device=None) -> torch.Tensor:
    """Centered-float complex64 capture seen by one antenna.

    background: optional pre-scaled GNSS baseband (centered domain, array
    or tensor); default zeros."""
    dev = as_device(device)
    g = jammers.make_generator(scn.seed * 1000 + antenna_index, dev)
    d = float(np.sqrt(((np.asarray(antenna_pos_m, dtype=np.float64)
                        - np.asarray(scn.position_m)) ** 2).sum()))
    amp = jammer_amplitude_at(scn, max(d, 1e-3))
    jam = jammers.generate(scn.kind, n_samples, sample_rate, generator=g,
                           device=dev)
    out = mix.inject_static(_background(background, n_samples, dev),
                            amp * jam, sample_rate, scn.start_s,
                            scn.duration_s, 1.0)
    return mix.finalize_uint8_domain(out, noise_std=noise_std, generator=g)


def write_capture_set(scn: JammerScenario, antenna_positions_m: Sequence,
                      paths: Sequence[str], n_samples: int,
                      sample_rate: float = C.DEFAULT_SAMPLE_RATE_GPS,
                      noise_std: float = 6.25, background=None,
                      device=None) -> None:
    """Render and write one .bin per antenna (the test1..3.bin pattern of
    worker.py:613-627)."""
    for i, (pos, path) in enumerate(zip(antenna_positions_m, paths)):
        cap = render_antenna_capture(scn, pos, n_samples, sample_rate,
                                     noise_std, background, antenna_index=i,
                                     device=device)
        iq_ops.write_iq_file(path, cap)


# ---------------------------------------------------------------------------
# Dynamic mode B: a moving jammer (the per-trajectory amplitude profile of
# add_jammer_and_mix.py:100-135). The jammer moves linearly from
# scn.position_m to `jammer_end_m` over the capture; its per-sample
# amplitude follows the path-loss model the RSSI localizer inverts,
# linearly interpolated between 10 Hz trajectory steps.
# ---------------------------------------------------------------------------

def moving_jammer_profile(scn: JammerScenario, antenna_pos_m, jammer_end_m,
                          n_samples: int, sample_rate: float,
                          rate_hz: float = 10.0,
                          device=None) -> torch.Tensor:
    """Per-sample jammer amplitude (float32, (n_samples,)) seen by one
    antenna for a linear start -> end jammer sweep (host float32, as the
    JAX package computes it)."""
    n_steps = max(int(np.ceil(n_samples / sample_rate * rate_hz)), 1)
    f = np.linspace(0.0, 1.0, n_steps + 1)
    start = np.asarray(scn.position_m, np.float64)
    end = np.asarray(jammer_end_m, np.float64)
    pos = start[None, :] * (1.0 - f[:, None]) + end[None, :] * f[:, None]
    d = np.sqrt(((pos - np.asarray(antenna_pos_m, np.float64)) ** 2)
                .sum(axis=1))
    amps = np.array([jammer_amplitude_at(scn, max(di, 1e-3)) for di in d],
                    np.float32)
    spp = int(np.ceil(n_samples / n_steps))
    frac = (np.arange(spp, dtype=np.float32) / spp)[None, :]
    segs = amps[:-1, None] + (amps[1:, None] - amps[:-1, None]) * frac
    return torch.from_numpy(np.ascontiguousarray(
        segs.reshape(-1)[:n_samples])).to(as_device(device))


def render_antenna_capture_moving(scn: JammerScenario, antenna_pos_m,
                                  jammer_end_m, n_samples: int,
                                  sample_rate: float,
                                  noise_std: float = 6.25, background=None,
                                  antenna_index: int = 0,
                                  device=None) -> torch.Tensor:
    """Dynamic-mode antenna capture: the jammer is on for the whole file,
    its amplitude the trajectory profile (its approach and departure form
    the detection window)."""
    dev = as_device(device)
    g = jammers.make_generator(scn.seed * 1000 + antenna_index, dev)
    jam = jammers.generate(scn.kind, n_samples, sample_rate, generator=g,
                           device=dev)
    prof = moving_jammer_profile(scn, antenna_pos_m, jammer_end_m,
                                 n_samples, sample_rate, device=dev)
    out = mix.inject_profile(_background(background, n_samples, dev), jam,
                             prof)
    return mix.finalize_uint8_domain(out, noise_std=noise_std, generator=g)


def write_moving_capture_set(scn: JammerScenario, antenna_positions_m,
                             jammer_end_m, paths: Sequence[str],
                             n_samples: int,
                             sample_rate: float = C.DEFAULT_SAMPLE_RATE_GPS,
                             noise_std: float = 6.25, background=None,
                             device=None) -> None:
    for i, (pos, path) in enumerate(zip(antenna_positions_m, paths)):
        cap = render_antenna_capture_moving(
            scn, pos, jammer_end_m, n_samples, sample_rate, noise_std,
            background, antenna_index=i, device=device)
        iq_ops.write_iq_file(path, cap)


# ---------------------------------------------------------------------------
# Modes A (clean / weakened GPS) and C (spoofer), the other two modes of
# the reference's simulation GUI (gnss_frontend.py:791-1307). Mode B (the
# jammer) is JammerScenario above; pass `background=` from gps_background
# to run it over a live constellation, as add_jammer_and_mix.py does.
# ---------------------------------------------------------------------------

DEFAULT_TOE_S = 345_600.0                # synthetic-shell ephemeris epoch


def synthetic_gps_shell(n_sats: int = 24, week: int = 2400,
                        toe: float = DEFAULT_TOE_S) -> list:
    """Walker-style synthetic GPS ephemeris shell (24 near-circular orbits
    over 6 planes), the stand-in for the reference's broadcast RINEX
    corpus (`data/sim_data/brdc2830.25n`) when no ephemeris file is given."""
    from ..models.receiver import lnav
    ephs = []
    for k in range(n_sats):
        ephs.append(lnav.Ephemeris(
            prn=k + 1, week=week, toc=toe, af0=0.0, af1=0.0, af2=0.0,
            tgd=0.0, iodc=100 + k, ura=1, health=0, iode=100 + k, toe=toe,
            sqrt_a=np.sqrt(26_560_000.0), e=0.008,
            m0=2.0 * np.pi * k / n_sats,
            delta_n=4.5e-9, omega0=2.0 * np.pi * (k % 6) / 6.0,
            omega_dot=-8.0e-9, omega=0.25 * k, i0=0.958, idot=-3e-10,
            cuc=0.0, cus=0.0, crc=0.0, crs=0.0, cic=0.0, cis=0.0,
            have_subframes=(1, 2, 3)))
    return ephs


def gps_background(rx_lla, tow0: float, n_samples: int, sample_rate: float,
                   ephs: Sequence | None = None, amplitude: float = 64.0,
                   seed: int = 0, end_lla=None):
    """Geometry-true GPS baseband in the centered-uint8 digital domain, on
    the host (the NumPy renderer, `sim.constellation`).

    The gps-sdr-sim role (`gnss_frontend.py:961-999`): ephemeris-consistent
    code phase, Doppler and nav bits for a receiver at `rx_lla`, scaled to
    `amplitude` digital units per satellite. end_lla: a MOVING receiver,
    linear rx_lla -> end_lla over the capture (the -u user-motion mode,
    10 Hz trajectory). Returns (complex64 (n_samples,), truths, rx_ecef)."""
    from . import constellation, trajectory
    shell = list(ephs) if ephs is not None else synthetic_gps_shell()
    traj = None
    if end_lla is not None:
        traj = trajectory.linear_trajectory(tuple(rx_lla), tuple(end_lla),
                                            n_samples / sample_rate)
    sig, truths, rx_ecef = constellation.simulate_constellation(
        shell, tuple(rx_lla), tow0, n_samples, sample_rate,
        noise_std=0.0, seed=seed, rx_traj=traj)
    return (sig * amplitude).astype(np.complex64), truths, rx_ecef


def write_clean_capture(path: str, rx_lla, n_samples: int,
                        sample_rate: float = C.DEFAULT_SAMPLE_RATE_GPS,
                        weaken_gps: bool = True, tow0: float | None = None,
                        ephs: Sequence | None = None, seed: int = 0,
                        end_lla=None, device=None) -> None:
    """Mode A: a clean or weakened GPS capture (`gnss_frontend.py:873-999`).

    weaken_gps applies weaken_gps.py's contract (x0.125 + AWGN sigma 6.25,
    generator seed + 17) before the uint8 clip-and-offset. end_lla: a
    moving receiver (mobile mode A, the generate_trajectory.py role)."""
    if tow0 is None:
        tow0 = DEFAULT_TOE_S - 1.3
    dev = as_device(device)
    bg, _, _ = gps_background(rx_lla, tow0, n_samples, sample_rate,
                              ephs=ephs, seed=seed, end_lla=end_lla)
    x = torch.from_numpy(bg).to(dev)
    if weaken_gps:
        x = mix.weaken(x, generator=jammers.make_generator(seed + 17, dev))
    iq_ops.write_iq_file(path, x)


def write_spoof_capture(path: str, true_lla, fake_lla, n_samples: int,
                        sample_rate: float = C.DEFAULT_SAMPLE_RATE_GPS,
                        start_s: float = -1.0, ramp_s: float = 0.5,
                        overpower: float = 4.0, noise_std: float = 4.0,
                        amplitude: float = 10.0, tow0: float | None = None,
                        ephs: Sequence | None = None, seed: int = 0,
                        device=None) -> np.ndarray:
    """Mode C: a spoofing-attack capture (`spoofer_mixer.py:29-171`).

    Renders the SAME ephemeris shell twice, for the receiver's true
    position and for the spoofer's fake one (the `*_fake_PRN.25n`
    workflow), and mixes them with the ramp-up envelope at `overpower`
    (noise from generator seed + 31). Returns the fake position's ECEF."""
    if tow0 is None:
        tow0 = DEFAULT_TOE_S - 1.3
    dev = as_device(device)
    shell = list(ephs) if ephs is not None else synthetic_gps_shell()
    legit, _, _ = gps_background(true_lla, tow0, n_samples, sample_rate,
                                 ephs=shell, amplitude=amplitude, seed=seed)
    spoof, _, fake_ecef = gps_background(fake_lla, tow0, n_samples,
                                         sample_rate, ephs=shell,
                                         amplitude=amplitude, seed=seed)
    mixed = mix.spoof_mix(torch.from_numpy(legit).to(dev),
                          torch.from_numpy(spoof).to(dev), sample_rate,
                          start_s=start_s, ramp_s=ramp_s,
                          overpower=overpower)
    out = mix.finalize_uint8_domain(
        mixed, noise_std=noise_std,
        generator=jammers.make_generator(seed + 31, dev))
    iq_ops.write_iq_file(path, out)
    return fake_ecef
