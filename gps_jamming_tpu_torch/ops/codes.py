"""Spreading codes, resampling and acquisition replica tables.

Counterpart of gps_jamming_tpu.ops.codes, whose NumPy builders are copied
because that module imports jax: GPS and SBAS C/A codes (IS-GPS-200 LFSR
definitions and the SBAS G2 delays), the GLONASS 511-chip code, BOC(1,1),
the floor-index resampler on tensors (`resample_code`) and its band-limited
form for fixtures. The acquisition replica is conj(FFT(sampled code)),
computed once on the host and moved to the device as one complex64 table.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import as_device
from ..utils import constants as C

# IS-GPS-200 G2 phase-selector tap pairs (1-indexed) for PRN 1..32.
_GPS_G2_TAPS = [
    (2, 6), (3, 7), (4, 8), (5, 9), (1, 9), (2, 10), (1, 8), (2, 9),
    (3, 10), (2, 3), (3, 4), (5, 6), (6, 7), (7, 8), (8, 9), (9, 10),
    (1, 4), (2, 5), (3, 6), (4, 7), (5, 8), (6, 9), (1, 3), (4, 6),
    (5, 7), (6, 8), (7, 9), (8, 10), (1, 6), (2, 7), (3, 8), (4, 9),
]


@functools.lru_cache(maxsize=64)
def gps_ca_code(prn: int) -> np.ndarray:
    """GPS L1 C/A code for one PRN as +/-1 int8, length 1023.

    Gold code: G1 (x^10 + x^3 + 1) XOR a two-tap phase of G2
    (x^10 + x^9 + x^8 + x^6 + x^3 + x^2 + 1).
    """
    if not 1 <= prn <= 32:
        raise ValueError(f"GPS PRN must be 1..32, got {prn}")
    t1, t2 = _GPS_G2_TAPS[prn - 1]
    g1 = np.ones(10, dtype=np.int8)
    g2 = np.ones(10, dtype=np.int8)
    out = np.empty(1023, dtype=np.int8)
    for i in range(1023):
        chip = g1[9] ^ (g2[t1 - 1] ^ g2[t2 - 1])
        out[i] = 1 - 2 * chip           # 0 -> +1, 1 -> -1
        fb1 = g1[2] ^ g1[9]
        fb2 = g2[1] ^ g2[2] ^ g2[5] ^ g2[7] ^ g2[8] ^ g2[9]
        g1[1:] = g1[:-1]
        g1[0] = fb1
        g2[1:] = g2[:-1]
        g2[0] = fb2
    return out


# Published G2 delays (chips) for SBAS PRN 120..138 (DO-229 / the
# IS-GPS-200 C/A family extension).
_SBAS_G2_DELAY = {
    120: 145, 121: 175, 122: 52, 123: 21, 124: 237, 125: 235, 126: 886,
    127: 657, 128: 634, 129: 762, 130: 355, 131: 1012, 132: 176, 133: 603,
    134: 130, 135: 359, 136: 595, 137: 68, 138: 386,
}


@functools.lru_cache(maxsize=1)
def _ca_base_sequences() -> tuple[np.ndarray, np.ndarray]:
    """Full-period (1023,) 0/1 G1 and G2 maximal-length sequences of the
    C/A family (G1: x^10+x^3+1; G2: x^10+x^9+x^8+x^6+x^3+x^2+1)."""
    g1 = np.ones(10, dtype=np.int8)
    g2 = np.ones(10, dtype=np.int8)
    s1 = np.empty(1023, np.int8)
    s2 = np.empty(1023, np.int8)
    for i in range(1023):
        s1[i] = g1[9]
        s2[i] = g2[9]
        fb1 = g1[2] ^ g1[9]
        fb2 = g2[1] ^ g2[2] ^ g2[5] ^ g2[7] ^ g2[8] ^ g2[9]
        g1[1:] = g1[:-1]
        g1[0] = fb1
        g2[1:] = g2[:-1]
        g2[0] = fb2
    return s1, s2


def ca_code_from_delay(delay_chips: int) -> np.ndarray:
    """C/A-family Gold code as +/-1 int8 from a G2 circular delay:
    C(t) = G1(t) xor G2((t - delay) mod 1023)."""
    s1, s2 = _ca_base_sequences()
    idx = (np.arange(1023) - delay_chips) % 1023
    return (1 - 2 * (s1 ^ s2[idx])).astype(np.int8)


@functools.lru_cache(maxsize=32)
def sbas_ca_code(prn: int) -> np.ndarray:
    """SBAS L1 C/A code for PRN 120..138 as +/-1 int8, length 1023."""
    if prn not in _SBAS_G2_DELAY:
        raise ValueError(f"SBAS PRN must be 120..138, got {prn}")
    return ca_code_from_delay(_SBAS_G2_DELAY[prn])


def sbas_ca_table() -> np.ndarray:
    """(19, 1023) float32 table of all SBAS C/A codes (PRN 120..138)."""
    return np.stack([sbas_ca_code(p)
                     for p in sorted(_SBAS_G2_DELAY)]).astype(np.float32)


@functools.lru_cache(maxsize=1)
def glonass_code() -> np.ndarray:
    """GLONASS 511-chip ranging code as +/-1 int8, shared by every FDMA
    channel: 9-stage LFSR x^9 + x^5 + 1, output from stage 7."""
    reg = np.ones(9, dtype=np.int8)
    out = np.empty(511, dtype=np.int8)
    for i in range(511):
        out[i] = 1 - 2 * reg[6]
        fb = reg[4] ^ reg[8]
        reg[1:] = reg[:-1]
        reg[0] = fb
    return out


def glonass_carrier_hz(freq_ch: int) -> float:
    """GLONASS FDMA carrier for channel number k (sdrinit.c:391-399 maps
    prn -> k = prn - 8)."""
    return C.GLO_G1_BASE_FREQ_HZ + freq_ch * C.GLO_G1_CH_SPACING_HZ


def boc11(code: np.ndarray) -> np.ndarray:
    """BOC(1,1): each chip split into (+c, -c) half-chips (Galileo E1B/E1C);
    doubles the chip rate."""
    return np.stack([code, -code], axis=-1).reshape(-1).astype(np.int8)


@functools.lru_cache(maxsize=8)
def gps_ca_table() -> np.ndarray:
    """(32, 1023) float32 table of all GPS C/A codes."""
    return np.stack([gps_ca_code(p) for p in range(1, 33)]).astype(np.float32)


def sample_times(n: int, sample_rate: float, device) -> torch.Tensor:
    """float32 t_i = i / fs, i < n, each quotient correctly rounded on
    every device, as the JAX package computes it. (CUDA divides by a
    Python float as a multiply by its reciprocal, one ulp off at many i;
    at MHz carriers that is 1e-3 rad of phase.)"""
    i = torch.arange(n, dtype=torch.float32, device=device)
    return i / torch.full((), sample_rate, dtype=torch.float32, device=device)


def resample_code(code: torch.Tensor, code_freq_hz, sample_rate_hz: float,
                  n_samples: int, rem_chips: float = 0.0,
                  chip_shift: float = 0.0) -> torch.Tensor:
    """Floor-neighbour resample of chip sequences to the sample rate, in
    float32 as the JAX package computes it: the chip index of sample i is
    floor(rem + chip_shift + i * fcode/fs) mod clen (`rescode`,
    sdrcmn.c:527-579).

    code: (..., clen) float tensor; code_freq_hz: a float, or a float32
    tensor over code's leading dims (one rate per row). Returns
    (..., n_samples).
    """
    clen = code.shape[-1]
    i = torch.arange(n_samples, dtype=torch.float32, device=code.device)
    if isinstance(code_freq_hz, torch.Tensor):
        # divide by a tensor, not a Python float (see sample_times): one
        # ulp in the rate moves floor() onto the neighbouring chip at
        # dozens of samples over 64k, and refine_doppler by ~1 Hz
        f = code_freq_hz.to(torch.float32)
        ratio = (f / torch.full_like(f, sample_rate_hz))[..., None]
    else:
        ratio = float(code_freq_hz / sample_rate_hz)
    phase = (rem_chips + chip_shift) + i * ratio
    idx = torch.floor(phase).to(torch.int64) % clen
    return torch.gather(code, -1, idx.expand(code.shape[:-1] + idx.shape[-1:]))


def resample_code_bandlimited(code: torch.Tensor, code_freq_hz: float,
                              sample_rate_hz: float, n_samples: int,
                              rem_chips: float = 0.0,
                              oversample: int = 4) -> torch.Tensor:
    """Band-limited resample of a chip sequence, for synthetic fixtures.

    The code is sampled at oversample x the rate, brick-wall filtered to
    +/- rate/2 and decimated, as a receiver's front end filters before its
    ADC. Without it, a square-wave BOC(1,1) code sampled raw aliases its
    2.046 MHz subcarrier line into the Doppler band.
    """
    hi = resample_code(code, code_freq_hz, sample_rate_hz * oversample,
                       n_samples * oversample, rem_chips)
    spec = torch.fft.fft(hi.to(torch.complex64), dim=-1)
    keep = n_samples // 2
    low = torch.cat([spec[..., :keep], spec[..., -keep:]], dim=-1)
    # ifft over n_samples normalizes by n_samples, not n_hi: rescale by 1/os
    return (torch.fft.ifft(low, dim=-1).real / oversample).to(torch.float32)


def resample_code_np(code_table: np.ndarray, code_freq_hz: float,
                     sample_rate_hz: float, n_samples: int,
                     rem_chips: float = 0.0) -> np.ndarray:
    """Floor-neighbour resample of chip sequences to the sample rate:
    chip index for sample i = floor(rem + i * fcode/fs) mod clen."""
    clen = code_table.shape[-1]
    phase = rem_chips + np.arange(n_samples) * (code_freq_hz / sample_rate_hz)
    idx = np.floor(phase).astype(np.int64) % clen
    return np.take(code_table, idx, axis=-1).astype(np.float32)


def sampled_code_fft_conj_host(code_table: np.ndarray, code_freq_hz: float,
                               sample_rate_hz: float,
                               n_samples: int) -> tuple[np.ndarray, np.ndarray]:
    """conj(FFT(sampled code)) as (re, im) float32 numpy planes."""
    sampled = resample_code_np(np.asarray(code_table, np.float32),
                               code_freq_hz, sample_rate_hz, n_samples)
    rep = np.conj(np.fft.fft(sampled, axis=-1))
    return (np.ascontiguousarray(rep.real, np.float32),
            np.ascontiguousarray(rep.imag, np.float32))


def gps_replica_table_host(sample_rate: float,
                           n_samples: int) -> tuple[np.ndarray, np.ndarray]:
    """(32, n) conj-FFT replica planes of all GPS PRNs, numpy float32."""
    return sampled_code_fft_conj_host(gps_ca_table(), C.GPS_CA_CHIP_RATE_HZ,
                                      sample_rate, n_samples)


@functools.lru_cache(maxsize=8)
def gps_replica_table(sample_rate: float, n_samples: int,
                      device=None) -> torch.Tensor:
    """(32, n) complex64 conj-FFT replica table on `device`.

    Cached per (rate, length, device): callers share one tensor and must not
    write to it."""
    return replica_tensor(gps_replica_table_host(sample_rate, n_samples),
                          device)


def replica_tensor(planes: tuple[np.ndarray, np.ndarray],
                   device=None) -> torch.Tensor:
    """(re, im) float32 replica planes -> a complex64 tensor on `device`."""
    re, im = planes
    return torch.complex(torch.from_numpy(re), torch.from_numpy(im)).to(
        as_device(device))
