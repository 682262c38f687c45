"""GPS C/A codes and acquisition replica tables (host NumPy builders).

Counterpart of the NumPy builders of gps_jamming_tpu.ops.codes, copied
because that module imports jax. Codes come from the IS-GPS-200 LFSR
definitions; the acquisition replica is conj(FFT(sampled code)), computed
once on the host and moved to the device as one complex64 table.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from gps_jamming_tpu.utils import constants as C

from ..device import as_device

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


@functools.lru_cache(maxsize=8)
def gps_ca_table() -> np.ndarray:
    """(32, 1023) float32 table of all GPS C/A codes."""
    return np.stack([gps_ca_code(p) for p in range(1, 33)]).astype(np.float32)


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
    re, im = gps_replica_table_host(sample_rate, n_samples)
    return torch.complex(torch.from_numpy(re), torch.from_numpy(im)).to(
        as_device(device))
