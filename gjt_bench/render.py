"""The benchmark's traffic generator: jammed GNSS captures rendered on the
device from a seed, as RTL-SDR interleaved uint8 I/Q.

A scene (a traffic file's "scene" object) is a constellation of CDMA (GPS
C/A) or FDMA (GLONASS L1OF) signals, complex white noise of `noise_std` per
component in the centred uint8 domain (u - 127.5), and one jammer whose
amplitude at each antenna follows the log-distance path-loss model the RSSI
localizer inverts (Prx = P - (20 log10 f_MHz - 27.55) - 10 n log10 d, in dB
of the normalized amplitude, x127.5 in the uint8 domain). Every antenna
sees the same satellites and its own noise. The number of satellites and
every size are fixed by the scene, so every seed gives the same work; the
seed draws which satellites, their Doppler, code phase, carrier phase, C/N0
and data symbols (host NumPy, a few hundred numbers), and the noise
(torch.Generator on the device).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .reference import codes

CHUNK = 1 << 22


def _path_loss_amplitude(jam: dict, pos) -> float:
    d = math.dist(jam["position_m"], pos)
    prx_db = (jam["tx_power_dbm"]
              - (20.0 * math.log10(jam["frequency_mhz"]) - 27.55)
              - 10.0 * jam["path_loss_exponent"] * math.log10(max(d, 1e-3)))
    return 10.0 ** (prx_db / 20.0) * 127.5


def draw_satellites(scene: dict, seed: int) -> list[dict]:
    """The seed's satellites: id (GPS PRN or GLONASS channel k), Doppler,
    Doppler rate, code phase (chips), carrier phase, C/N0 and symbols."""
    rng = np.random.default_rng([int(seed), 0x6A7])
    sats = scene["satellites"]
    pool = np.arange(sats["ids"][0], sats["ids"][1] + 1)
    ids = np.sort(rng.choice(pool, size=sats["count"], replace=False))
    clen = codes.GPS_CODE_LEN if scene["system"] == "gps" \
        else codes.GLO_CODE_LEN
    n_sym = int(math.ceil(scene["seconds"] * 1000.0 / sats["symbol_ms"])) + 2
    out = []
    for sid in ids:
        out.append({
            "id": int(sid),
            "doppler_hz": float(rng.uniform(*sats["doppler_hz"])),
            "doppler_rate_hz_s": float(rng.uniform(
                *sats["doppler_rate_hz_per_s"])),
            "code_phase_chips": float(rng.uniform(0.0, clen)),
            "carrier_phase_rad": float(rng.uniform(0.0, 2.0 * np.pi)),
            "cn0_dbhz": float(rng.uniform(*sats["cn0_dbhz"])),
            "symbols": rng.choice([-1.0, 1.0], size=n_sym),
        })
    return out


def _signal_chunk(scene: dict, sats: list[dict], i0: int, m: int, dev):
    """complex128 (m,) satellite sum for samples [i0, i0 + m)."""
    fs = float(scene["sample_rate_hz"])
    sigma = float(scene["noise_std"])
    t = (torch.arange(m, dtype=torch.float64, device=dev) + i0) / fs
    out = torch.zeros(m, dtype=torch.complex128, device=dev)
    gps = scene["system"] == "gps"
    code = torch.from_numpy(codes.glonass_st()).to(dev) if not gps else None
    chip_rate = codes.GPS_CHIP_RATE_HZ if gps else codes.GLO_CHIP_RATE_HZ
    for s in sats:
        if gps:
            code = torch.from_numpy(codes.gps_ca(s["id"])).to(dev)
            f_carrier, f_offset = codes.GPS_L1_HZ, 0.0
        else:
            f_offset = s["id"] * codes.GLO_SPACING_HZ
            f_carrier = codes.GLO_G1_HZ + f_offset
        d0, dr = s["doppler_hz"], s["doppler_rate_hz_s"]
        dphase = d0 * t + 0.5 * dr * t * t                # cycles of Doppler
        chips = s["code_phase_chips"] + chip_rate * (t + dphase / f_carrier)
        c = code[torch.floor(chips).to(torch.int64) % code.numel()]
        sym_chips = code.numel() * scene["satellites"]["symbol_ms"]
        sym = torch.from_numpy(s["symbols"]).to(dev)[
            torch.floor(chips / sym_chips).to(torch.int64)]
        phase = 2.0 * math.pi * (f_offset * t + dphase) \
            + s["carrier_phase_rad"]
        amp = math.sqrt(10.0 ** (s["cn0_dbhz"] / 10.0) * 2.0 * sigma ** 2
                        / fs)
        out += amp * c * sym * torch.polar(torch.ones_like(phase), phase)
    return out, t


def _jammer_chunk(jam: dict, t: torch.Tensor) -> torch.Tensor:
    """Unit-amplitude sawtooth chirp, gated to [start_s, stop_s)."""
    tau = torch.fmod(t, jam["sweep_s"])
    k = (jam["f_stop_hz"] - jam["f_start_hz"]) / jam["sweep_s"]
    phase = 2.0 * math.pi * (jam["f_start_hz"] * tau + 0.5 * k * tau * tau)
    gate = ((t >= jam["start_s"]) & (t < jam["stop_s"])).to(torch.float64)
    return gate * torch.polar(torch.ones_like(phase), phase)


def render_scene(scene: dict, seed: int, device) -> list[torch.Tensor]:
    """One (2n,) uint8 interleaved I/Q tensor on `device` per antenna."""
    if scene["jammer"]["kind"] != "chirp":
        raise ValueError(f"jammer kind {scene['jammer']['kind']!r}: only "
                         f"'chirp' is rendered")
    dev = torch.device(device)
    fs = float(scene["sample_rate_hz"])
    n = int(round(scene["seconds"] * fs))
    sats = draw_satellites(scene, seed)
    jam = scene["jammer"]
    ants = scene["antennas_m"]
    amps = [_path_loss_amplitude(jam, p) for p in ants]
    gens = []
    for a in range(len(ants)):
        g = torch.Generator(device=dev)
        g.manual_seed((int(seed) * 7919 + 104729 * (a + 1)) % (1 << 63))
        gens.append(g)
    outs = [torch.empty(2 * n, dtype=torch.uint8, device=dev) for _ in ants]
    sigma = float(scene["noise_std"])
    for i0 in range(0, n, CHUNK):
        m = min(CHUNK, n - i0)
        sig, t = _signal_chunk(scene, sats, i0, m, dev)
        jw = _jammer_chunk(jam, t)
        for a in range(len(ants)):
            noise = torch.randn((2, m), generator=gens[a], dtype=torch.float32,
                                device=dev).to(torch.float64) * sigma
            x = sig + amps[a] * jw
            iq = torch.stack([x.real + noise[0], x.imag + noise[1]], dim=-1)
            u = torch.clamp(torch.floor(iq + 128.0), 0.0, 255.0)
            outs[a][2 * i0: 2 * (i0 + m)] = u.reshape(-1).to(torch.uint8)
    return outs
