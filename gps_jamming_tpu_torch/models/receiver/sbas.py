"""SBAS L1 message layer: the K=7 rate-1/2 FEC stream, CRC-24Q framing and
MT12.

NumPy copy of `gps_jamming_tpu.models.receiver.sbas`;
tests/test_torch_decoders.py holds the two equal. The reference's SBAS path
is `sdrnav_sbs.c:1-99` (MT12) over `predecodefec` (sdrnav.c:194-236,
libfec's Viterbi) and rtkcmn's CRC24Q: 250-bit messages at 250 bps in a
continuous rate-1/2 convolutional symbol stream (500 sps), the preamble
cycling 0x53 / 0x9A / 0xC6, CRC-24Q over the first 226 bits. The FEC is
`utils.fec` with G2 not inverted (unlike Galileo E1B), on the host.

Message layout (RTCA DO-229): preamble(8) | MT(6) | data(212) | CRC(24).
MT12 carries time: data[0:20] = GPS ToW seconds, data[20:30] = week (the
fields sdrnav_sbs.c:47-97 extracts).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ...utils import crc as crc_mod
from ...utils import fec
from .lnav import pack_bits, unpack_u

MSG_BITS = 250
PREAMBLES = (0x53, 0x9A, 0xC6)
MT12 = 12


def _preamble_bits(value: int) -> np.ndarray:
    return pack_bits(value, 8)


def build_message(mt: int, data212: np.ndarray, preamble_idx: int = 0
                  ) -> np.ndarray:
    """250-bit SBAS message with its CRC-24Q (MSB-first bit array)."""
    data212 = np.asarray(data212, np.int64) & 1
    assert data212.size == 212
    head = np.concatenate([_preamble_bits(PREAMBLES[preamble_idx % 3]),
                           pack_bits(mt, 6), data212])
    crc = pack_bits(crc_mod.crc24q_bits(head), 24)
    return np.concatenate([head, crc])


def build_mt12(tow_s: float, week: int, preamble_idx: int = 0) -> np.ndarray:
    data = np.zeros(212, np.int64)
    data[0:20] = pack_bits(int(round(tow_s)), 20)
    data[20:30] = pack_bits(week, 10)
    return build_message(MT12, data, preamble_idx)


def encode_stream(messages: list[np.ndarray]) -> np.ndarray:
    """Continuous rate-1/2 encode of the concatenated messages -> 500 sps
    symbols (the SBAS coder never terminates: one register across message
    boundaries)."""
    bits = np.concatenate(messages)
    return fec.encode(bits, invert_g2=False, terminate=False)


@dataclasses.dataclass
class SbasMessage:
    mt: int
    data: np.ndarray             # 212 bits
    bit_offset: int              # offset of the preamble in decoded bits
    tow_s: float | None = None
    week: int | None = None


def decode_stream(symbols: np.ndarray) -> list[SbasMessage]:
    """Symbol stream (hard or soft, aligned to a message or not) ->
    CRC-valid messages. One Viterbi decode of the whole stream (the coder
    is continuous), then a preamble + CRC check at every offset (the
    findpreamble and paritycheck roles, sdrnav.c:238-328)."""
    bits = fec.viterbi_decode(np.asarray(symbols, np.float64),
                              invert_g2=False, terminated=False)
    out = []
    pre = [_preamble_bits(p) for p in PREAMBLES]
    for i in range(bits.size - MSG_BITS + 1):
        w = bits[i:i + 8]
        if not any(np.array_equal(w, p) for p in pre):
            continue
        msg = bits[i:i + MSG_BITS]
        if crc_mod.crc24q_bits(msg[:226]) != unpack_u(msg[226:250]):
            continue
        mt = unpack_u(msg[8:14])
        data = msg[14:226]
        rec = SbasMessage(mt=mt, data=data, bit_offset=i)
        if mt == MT12:
            rec.tow_s = float(unpack_u(data[0:20]))
            rec.week = unpack_u(data[20:30])
        out.append(rec)
    return out
