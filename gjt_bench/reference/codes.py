"""Ranging codes, written from the signal specifications.

GPS L1 C/A (IS-GPS-200, table 3-Ia): the Gold code G1 xor G2, G1 = 1 + x^3 +
x^10, G2 = 1 + x^2 + x^3 + x^6 + x^8 + x^9 + x^10, each PRN's G2 output the
xor of two of its stages. GLONASS L1OF (ICD 2008, 3.3.1.3): the 511-chip
m-sequence of 1 + x^5 + x^9, read from stage 7, the same on every channel.
Chips are +/-1 (a 0 bit is +1).
"""
from __future__ import annotations

import functools

import numpy as np

GPS_CHIP_RATE_HZ = 1.023e6
GPS_CODE_LEN = 1023
GPS_L1_HZ = 1575.42e6
GLO_CHIP_RATE_HZ = 0.511e6
GLO_CODE_LEN = 511
GLO_G1_HZ = 1602.0e6
GLO_SPACING_HZ = 562.5e3

# G2 stages (1-based) whose xor is each PRN's delayed G2 output
_G2_TAPS = (
    (2, 6), (3, 7), (4, 8), (5, 9), (1, 9), (2, 10), (1, 8), (2, 9),
    (3, 10), (2, 3), (3, 4), (5, 6), (6, 7), (7, 8), (8, 9), (9, 10),
    (1, 4), (2, 5), (3, 6), (4, 7), (5, 8), (6, 9), (1, 3), (4, 6),
    (5, 7), (6, 8), (7, 9), (8, 10), (1, 6), (2, 7), (3, 8), (4, 9),
)


@functools.lru_cache(maxsize=None)
def gps_ca(prn: int) -> np.ndarray:
    """(1023,) float64 +/-1 C/A code of `prn` (1..32)."""
    a, b = _G2_TAPS[prn - 1]
    g1 = [1] * 10
    g2 = [1] * 10
    out = np.empty(GPS_CODE_LEN)
    for i in range(GPS_CODE_LEN):
        out[i] = 1.0 - 2.0 * (g1[9] ^ g2[a - 1] ^ g2[b - 1])
        f1 = g1[2] ^ g1[9]
        f2 = g2[1] ^ g2[2] ^ g2[5] ^ g2[7] ^ g2[8] ^ g2[9]
        g1 = [f1] + g1[:9]
        g2 = [f2] + g2[:9]
    return out


@functools.lru_cache(maxsize=None)
def glonass_st() -> np.ndarray:
    """(511,) float64 +/-1 GLONASS standard-accuracy code."""
    reg = [1] * 9
    out = np.empty(GLO_CODE_LEN)
    for i in range(GLO_CODE_LEN):
        out[i] = 1.0 - 2.0 * reg[6]
        reg = [reg[4] ^ reg[8]] + reg[:8]
    return out


def sampled(code: np.ndarray, chip_rate: float, fs: float, n: int,
            start_chip: float = 0.0) -> np.ndarray:
    """The code held over each sample: chip floor(start + i * rate / fs)."""
    idx = np.floor(start_chip + np.arange(n) * (chip_rate / fs))
    return code[idx.astype(np.int64) % code.size]
