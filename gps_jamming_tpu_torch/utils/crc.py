"""CRC-24Q (Qualcomm), the GNSS frame CRC.

NumPy copy of `gps_jamming_tpu.utils.crc`; tests/test_torch_fec_crc.py
holds the two equal bit for bit. The vendored rtklib `crc24q`
(lib/rtklib/rtkcmn.c) and the reference's validation tooling
(`helpers/crc24q.py`) compute the same function. Galileo I/NAV pages
(checkcrc_e1b, sdrnav_gal.c:198-233) and SBAS messages check it.
Polynomial 0x1864CFB, init 0, no reflection, no final xor.
"""
from __future__ import annotations

import numpy as np

_POLY = 0x1864CFB


def _make_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        crc = i << 16
        for _ in range(8):
            crc <<= 1
            if crc & 0x1000000:
                crc ^= _POLY
        table[i] = crc & 0xFFFFFF
    return table


_TABLE = _make_table()


def crc24q(data: bytes | np.ndarray) -> int:
    """CRC-24Q over bytes (MSB first)."""
    data = np.frombuffer(bytes(data), dtype=np.uint8) \
        if isinstance(data, (bytes, bytearray)) else \
        np.asarray(data, dtype=np.uint8)
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFFFF) ^ int(_TABLE[((crc >> 16) ^ b) & 0xFF])
    return crc


def crc24q_bits(bits: np.ndarray) -> int:
    """CRC-24Q over an MSB-first 0/1 bit array of any length, clocked once
    per bit (the GNSS convention: no padding to a byte boundary on the
    left)."""
    bits = np.asarray(bits, dtype=np.uint8) & 1
    crc = 0
    for b in bits:
        top = ((crc >> 23) ^ b) & 1
        crc = (crc << 1) & 0xFFFFFF
        if top:
            crc ^= _POLY & 0xFFFFFF
    return crc


def check_crc24q(data: bytes, expected: int) -> bool:
    return crc24q(data) == expected
