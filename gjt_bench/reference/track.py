"""Plain reference of what a tracking loop in lock reports for one
satellite, from the capture's bytes and the satellite's true trajectory.

- Trajectory (the scene's own model of a satellite): Doppler d0 + dr t,
  carrier cycles f_offset t + d0 t + dr t^2 / 2 (f_offset: a GLONASS
  channel's FDMA offset), code chips c0 + chip_rate (t + Doppler cycles /
  carrier frequency).
- Correlations, per period of the code (q = floor(chips / code length), so
  that a data symbol never changes inside one): the prompt, the samples
  times the code at their true chip times the wiped-off carrier, and the
  same with the code `tap` samples early. The carrier's phase is wrapped at
  every 1 ms block of samples, as a numerically controlled oscillator
  keeps it.
- C/N0, the estimator the configuration states: prompt power S and early
  tap power N, each smoothed by an exponential average over `smooth_ms`
  (both starting at 1), 10 log10(max(S - N, 1e-12) / max(N, 1e-12) /
  1 ms).
"""
from __future__ import annotations

import math
import struct

import numpy as np
import torch

from . import codes

CHUNK = 1 << 21


def system_constants(system: str) -> dict:
    if system == "gps":
        return {"code": codes.gps_ca, "chip_rate": codes.GPS_CHIP_RATE_HZ,
                "carrier": codes.GPS_L1_HZ, "spacing": 0.0}
    return {"code": lambda _id: codes.glonass_st(),
            "chip_rate": codes.GLO_CHIP_RATE_HZ, "carrier": codes.GLO_G1_HZ,
            "spacing": codes.GLO_SPACING_HZ}


def offset_hz(system: str, sat_id: int) -> float:
    return sat_id * system_constants(system)["spacing"]


def doppler_hz(sat: dict, t):
    return sat["doppler_hz"] + sat["doppler_rate_hz_s"] * t


def chips_at(sat: dict, system: str, t):
    """The code's chip count at time(s) `t` (NumPy or torch, float64)."""
    k = system_constants(system)
    f_carrier = k["carrier"] + offset_hz(system, sat["id"])
    dcyc = sat["doppler_hz"] * t + 0.5 * sat["doppler_rate_hz_s"] * t * t
    return sat["code_phase_chips"] + k["chip_rate"] * (t + dcyc / f_carrier)


def period_at(sat: dict, system: str, t) -> np.ndarray:
    """Index q of the code period that holds time(s) `t`."""
    code_len = system_constants(system)["code"](sat["id"]).size
    return np.floor(chips_at(sat, system, np.asarray(t, np.float64))
                    / code_len).astype(np.int64)


def _bf16(v: float) -> float:
    """`v` rounded to the nearest bfloat16 (ties to even)."""
    (b,) = struct.unpack("<I", struct.pack("<f", v))
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return struct.unpack("<f", struct.pack("<I", b))[0]


def _round_t(a: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float64":
        return a
    if a.is_complex():
        return torch.complex(_round_t(a.real, precision),
                             _round_t(a.imag, precision))
    return a.to(torch.bfloat16).to(torch.float64)


def correlations(raw_u8: np.ndarray, sat: dict, system: str, fs: float,
                 tap: int = 4, precision: str = "float64",
                 device="cpu") -> tuple[int, np.ndarray, np.ndarray]:
    """(q0, prompt, early): complex128 sums over each whole code period
    q0, q0 + 1, ... of the capture."""
    dev = torch.device(device)
    k = system_constants(system)
    code = torch.from_numpy(k["code"](sat["id"])).to(dev)
    clen = code.numel()
    n = raw_u8.size // 2
    n_blk = int(round(fs * 1e-3))
    f_off = offset_hz(system, sat["id"])
    q_first = int(period_at(sat, system, 0.0))
    q_last = int(period_at(sat, system, (n - 1) / fs))
    n_q = q_last - q_first + 1
    acc = torch.zeros((4, n_q), dtype=torch.float64, device=dev)
    for i0 in range(0, n, CHUNK):
        m = min(CHUNK, n - i0)
        u = torch.from_numpy(raw_u8[2 * i0: 2 * (i0 + m)]).to(dev)
        v = u.to(torch.float64) - 127.5
        x = torch.complex(v[0::2], v[1::2])
        idx = torch.arange(i0, i0 + m, dtype=torch.float64, device=dev)
        t = idx / fs
        chips = chips_at(sat, system, t)
        q = torch.floor(chips / clen).to(torch.int64) - q_first
        code_p = code[torch.floor(chips).to(torch.int64) % clen]
        chips_e = chips_at(sat, system, t - tap / fs)
        code_e = code[torch.floor(chips_e).to(torch.int64) % clen]
        # carrier cycles, wrapped at the start of each 1 ms block
        cyc = f_off * t + sat["doppler_hz"] * t \
            + 0.5 * sat["doppler_rate_hz_s"] * t * t
        tb = torch.floor(idx / n_blk) * n_blk / fs
        cyc_b = f_off * tb + sat["doppler_hz"] * tb \
            + 0.5 * sat["doppler_rate_hz_s"] * tb * tb
        phase = _round_t(2.0 * math.pi * (cyc - torch.floor(cyc_b))
                         + sat["carrier_phase_rad"], precision)
        wipe = _round_t(torch.polar(torch.ones_like(phase), -phase),
                        precision)
        xw = _round_t(x * wipe, precision)
        for j, c in ((0, code_p), (2, code_e)):
            prod = _round_t(xw * c, precision)
            acc[j].index_add_(0, q, prod.real)
            acc[j + 1].index_add_(0, q, prod.imag)
    sums = acc.cpu().numpy()
    prompt = sums[0] + 1j * sums[1]
    early = sums[2] + 1j * sums[3]
    # the first and last periods are cut by the capture's ends
    return q_first + 1, prompt[1:-1], early[1:-1]


def cn0(prompt: np.ndarray, early: np.ndarray, smooth_ms: float = 100.0,
        epoch_s: float = 1e-3, precision: str = "float64") -> np.ndarray:
    """C/N0 (dB-Hz) after each period, from the periods' correlations."""
    alpha = 1.0 / max(smooth_ms * 1e-3 / epoch_s, 1.0)
    p_sig = np.abs(prompt) ** 2
    p_noise = np.abs(early) ** 2
    rnd = _bf16 if precision == "bfloat16" else float
    sig = noise = 1.0
    out = np.empty(p_sig.size)
    for i in range(p_sig.size):
        sig = rnd(sig + rnd(alpha * rnd(rnd(p_sig[i]) - sig)))
        noise = rnd(noise + rnd(alpha * rnd(rnd(p_noise[i]) - noise)))
        snr = max(rnd(sig - noise), 1e-12) / max(noise, 1e-12)
        out[i] = 10.0 * math.log10(snr / epoch_s)
    return out


def cn0_series(raw_u8: np.ndarray, sat: dict, system: str, fs: float,
               tap: int = 4, smooth_ms: float = 100.0,
               precision: str = "float64", device="cpu"
               ) -> tuple[int, np.ndarray]:
    """(q0, C/N0 after each whole code period q0, q0 + 1, ...)."""
    q0, p, e = correlations(raw_u8, sat, system, fs, tap, precision, device)
    return q0, cn0(p, e, smooth_ms, precision=precision)
