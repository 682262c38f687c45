"""Galileo E1B codes (counterpart of the code half of
gps_jamming_tpu.models.receiver.galileo; the I/NAV page codec is not ported
yet).

E1B acquisition is the generic std or PCF search with E1B parameters:
a 4092-chip primary code, BOC(1,1) to 8184 half-chips at 2.046 Mcps, a
4 ms period. The primary codes are the Galileo OS SIS ICD memory codes,
read from the port's own copy of the shipped table,
`data/e1b_primary_codes.npz` beside this module.
"""
from __future__ import annotations

import functools
import os

import numpy as np

from ...ops import codes as codes_ops
from ...utils import constants as C

CODE_LEN = C.GAL_E1B_CODE_LEN                  # 4092
BOC_LEN = 2 * CODE_LEN                         # 8184 half-chips
BOC_RATE = 2.046e6
PERIOD_S = C.GAL_E1B_PERIOD_S                  # 4 ms
ICD_TABLE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "data", "e1b_primary_codes.npz")

# Per-PRN overrides loaded by `load_icd_codes`; they win over the table.
_ICD_CODES: dict[int, np.ndarray] = {}


@functools.lru_cache(maxsize=1)
def _icd_table() -> np.ndarray:
    """The shipped ICD primary-code table, (50, 4092) int8 chips in +/-1
    (logical 0 -> +1)."""
    with np.load(ICD_TABLE_PATH) as z:
        bits = np.unpackbits(z["packed"], axis=1)[:, :int(z["n_chips"])]
    return 1 - 2 * bits.astype(np.int8)


def load_icd_codes(path: str) -> int:
    """Load E1B primary codes from a hex file: lines "<prn> <hex>" with
    1023 hex chars (4092 bits) per PRN. Returns the count loaded."""
    n = 0
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 2:
                continue
            prn = int(parts[0])
            h = parts[1].strip()
            bits = np.array([int(c) for c in bin(int(h, 16))[2:].zfill(
                len(h) * 4)], np.int8)[:CODE_LEN]
            _ICD_CODES[prn] = 1 - 2 * bits
            n += 1
    return n


def e1b_code(prn: int) -> np.ndarray:
    """E1B primary code, +/-1 int8 of length 4092: the ICD memory code
    (a `load_icd_codes` override wins)."""
    if prn in _ICD_CODES:
        return _ICD_CODES[prn]
    return _icd_table()[prn - 1]


def synthetic_e1b_code(prn: int) -> np.ndarray:
    """A deterministic balanced placeholder code, NOT the ICD sequence: a
    fixture for tests that a receiver on the ICD table rejects it."""
    rng = np.random.default_rng(0xE1B0000 + prn)
    return rng.integers(0, 2, CODE_LEN).astype(np.int8) * 2 - 1


def e1b_boc_code(prn: int) -> np.ndarray:
    """BOC(1,1)-modulated code: 8184 half-chips at 2.046 Mcps."""
    return codes_ops.boc11(e1b_code(prn))


def boc_table(prns) -> np.ndarray:
    return np.stack([e1b_boc_code(p) for p in prns])


def replica_table_host(sample_rate: float, n_samples: int,
                       prns=None) -> tuple[np.ndarray, np.ndarray]:
    """conj(FFT) acquisition replicas over one 4 ms period, as (re, im)
    float32 planes (PRN 1..36 unless `prns` is given)."""
    prns = prns if prns is not None else range(1, C.GAL_NUM_PRN + 1)
    return codes_ops.sampled_code_fft_conj_host(
        boc_table(list(prns)), BOC_RATE, sample_rate, n_samples)
