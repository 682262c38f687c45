"""The traffic generator of the Galileo cells: jammed Galileo E1B captures
rendered on the device from a seed, as interleaved uint8 I/Q.

A scene (a traffic file's "scene" object, `"system": "galileo"`) is a
constellation of E1B signals (the ICD memory codes of
`reference/galileo_monitor.py` on BOC(1,1) at 2.046 MHz of half-chips, a
data symbol per `symbol_ms`, no E1C pilot), complex white noise of
`noise_std` per component in the centred uint8 domain (u - 127.5), and one
jammer whose amplitude at each antenna follows `render.py`'s
log-distance path-loss model, as a chirp of `render.py`'s. Every antenna
sees the same satellites and its own noise. The number of satellites and
every size are fixed by the scene, so every seed gives the same work; the
seed draws which satellites, their Doppler, code phase, carrier phase,
C/N0 and data symbols (host NumPy, a few hundred numbers), and the noise
(torch.Generator on the device).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import render
from .reference import galileo_monitor as gal


def draw_satellites(scene: dict, seed: int) -> list[dict]:
    """The seed's satellites: E1B PRN, Doppler, Doppler rate, code phase
    (chips), carrier phase, C/N0 and symbols."""
    rng = np.random.default_rng([int(seed), 0xE1B])
    sats = scene["satellites"]
    pool = np.arange(sats["ids"][0], sats["ids"][1] + 1)
    ids = np.sort(rng.choice(pool, size=sats["count"], replace=False))
    n_sym = int(math.ceil(scene["seconds"] * 1000.0 / sats["symbol_ms"])) + 2
    out = []
    for sid in ids:
        out.append({
            "id": int(sid),
            "doppler_hz": float(rng.uniform(*sats["doppler_hz"])),
            "doppler_rate_hz_s": float(rng.uniform(
                *sats["doppler_rate_hz_per_s"])),
            "code_phase_chips": float(rng.uniform(0.0, gal.E1B_CODE_LEN)),
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
    sym_chips = gal.E1B_CHIP_RATE_HZ * scene["satellites"]["symbol_ms"] \
        * 1e-3
    for s in sats:
        boc = gal.e1b_boc(s["id"], dev)
        d0, dr = s["doppler_hz"], s["doppler_rate_hz_s"]
        dphase = d0 * t + 0.5 * dr * t * t                # cycles of Doppler
        chips = s["code_phase_chips"] + gal.E1B_CHIP_RATE_HZ * (
            t + dphase / gal.E1_HZ)
        c = boc[torch.floor(2.0 * chips).to(torch.int64) % boc.numel()]
        sym = torch.from_numpy(s["symbols"]).to(dev)[
            torch.floor(chips / sym_chips).to(torch.int64)]
        phase = 2.0 * math.pi * dphase + s["carrier_phase_rad"]
        amp = math.sqrt(10.0 ** (s["cn0_dbhz"] / 10.0) * 2.0 * sigma ** 2
                        / fs)
        out += amp * c * sym * torch.polar(torch.ones_like(phase), phase)
    return out, t


def render_scene(scene: dict, seed: int, device) -> list[torch.Tensor]:
    """One (2n,) uint8 interleaved I/Q tensor on `device` per antenna."""
    if scene["system"] != "galileo":
        raise ValueError(f"system {scene['system']!r}: this generator "
                         f"renders 'galileo' (render.py the others)")
    if scene["jammer"]["kind"] != "chirp":
        raise ValueError(f"jammer kind {scene['jammer']['kind']!r}: only "
                         f"'chirp' is rendered")
    dev = torch.device(device)
    fs = float(scene["sample_rate_hz"])
    n = int(round(scene["seconds"] * fs))
    sats = draw_satellites(scene, seed)
    jam = scene["jammer"]
    ants = scene["antennas_m"]
    amps = [render._path_loss_amplitude(jam, p) for p in ants]
    gens = []
    for a in range(len(ants)):
        g = torch.Generator(device=dev)
        g.manual_seed((int(seed) * 7919 + 104729 * (a + 1)) % (1 << 63))
        gens.append(g)
    outs = [torch.empty(2 * n, dtype=torch.uint8, device=dev) for _ in ants]
    sigma = float(scene["noise_std"])
    for i0 in range(0, n, render.CHUNK):
        m = min(render.CHUNK, n - i0)
        sig, t = _signal_chunk(scene, sats, i0, m, dev)
        jw = render._jammer_chunk(jam, t)
        for a in range(len(ants)):
            noise = torch.randn((2, m), generator=gens[a], dtype=torch.float32,
                                device=dev).to(torch.float64) * sigma
            x = sig + amps[a] * jw
            iq = torch.stack([x.real + noise[0], x.imag + noise[1]], dim=-1)
            u = torch.clamp(torch.floor(iq + 128.0), 0.0, 255.0)
            outs[a][2 * i0: 2 * (i0 + m)] = u.reshape(-1).to(torch.uint8)
    return outs
