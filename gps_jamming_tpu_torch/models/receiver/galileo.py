"""Galileo E1B codes and the I/NAV page codec (counterpart of
gps_jamming_tpu.models.receiver.galileo; the codec is a NumPy copy, held
equal by tests/test_torch_decoders.py).

E1B acquisition is the generic std or PCF search with E1B parameters:
a 4092-chip primary code, BOC(1,1) to 8184 half-chips at 2.046 Mcps, a
4 ms period. The primary codes are the Galileo OS SIS ICD memory codes,
read from the port's own copy of the shipped table,
`data/e1b_primary_codes.npz` beside this module.

I/NAV nominal page (ICD 4.3.2; the reference's `sdrnav_gal.c:20-275`):
per 1 s half page, 120 bits (114 info + 6 tail) -> K=7 rate-1/2
convolutional code with G2 inverted (`utils.fec`) -> 8x30 block
interleaver -> 10-bit sync + 240 symbols. A 2 s nominal page is an even
and an odd half; its 196-bit CRC-24Q spans both halves' info fields. Word
types 1-5 carry the Keplerian ephemeris and GST, parsed into the GPS
chain's `lnav.Ephemeris`, so PVT is the same for both systems.
"""
from __future__ import annotations

import copy
import functools
import os

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from ...ops import codes as codes_ops
from ...utils import constants as C
from ...utils import crc as crc_mod
from ...utils import fec
from .lnav import Ephemeris, UtcParams as Utc, pack_bits, unpack_s, unpack_u

SYNC = np.array([0, 1, 0, 1, 1, 0, 0, 0, 0, 0], np.int64)
PAGE_SYMBOLS = 240
HALF_PAGE_BITS = 120           # 114 info + 6 tail
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


def replica_table(sample_rate: float, n_samples: int, device=None,
                  prns=None):
    """(P, n) complex64 conj-FFT replica table of `replica_table_host` on
    `device` (None: the card), at any rate: E1B PRN 1..36 unless `prns`
    is given."""
    return codes_ops.replica_tensor(
        replica_table_host(sample_rate, n_samples, prns), device)


# ---------------------------------------------------------------------------
# I/NAV page codec
# ---------------------------------------------------------------------------

def interleave(symbols240: np.ndarray) -> np.ndarray:
    """8x30 block interleaver: written column-wise, read row-wise."""
    return np.asarray(symbols240).reshape(30, 8).T.reshape(-1)


def deinterleave(symbols240: np.ndarray) -> np.ndarray:
    return np.asarray(symbols240).reshape(8, 30).T.reshape(-1)


def encode_half_page(info114: np.ndarray) -> np.ndarray:
    """114 info bits -> 250 transmitted symbols (sync + FEC + interleave)."""
    sym = fec.encode(np.asarray(info114, np.int64), invert_g2=True,
                     terminate=True)
    assert sym.size == PAGE_SYMBOLS
    return np.concatenate([SYNC, interleave(sym)])


def decode_half_page(symbols250: np.ndarray, max_sync_errors: int = 0):
    """250 symbols -> (ok_sync, 114 info bits). Accepts soft [0,1].

    Sync is matched in both polarities with up to `max_sync_errors` hard
    bit errors; the CRC of the paired nominal page is the real validator.
    """
    s = np.asarray(symbols250, np.float64)
    hard_sync = (s[:10] > 0.5).astype(np.int64)
    d_pos = int(np.sum(hard_sync ^ SYNC))
    d_neg = int(np.sum(hard_sync ^ SYNC ^ 1))
    if min(d_pos, d_neg) > max_sync_errors:
        return False, None
    flip = 1 if d_neg < d_pos else 0
    body = s[10:]
    if flip:
        body = 1.0 - body
    bits = fec.viterbi_decode(deinterleave(body), invert_g2=True,
                              terminated=True)
    return True, bits


def build_nominal_page(data128: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """128 data bits -> (even_info114, odd_info114) with CRC24Q.

    even = [0(even), 0(nominal), data[0:112]];
    odd  = [1, 0, data[112:128], reserved1(40)=0, sar(22)=0, spare(2)=0,
            crc(24), reserved2(8)=0]; CRC spans even[0:114] + odd[0:82].
    """
    data128 = np.asarray(data128, np.int64) & 1
    even = np.concatenate([[0, 0], data128[:112]])
    odd_head = np.concatenate([[1, 0], data128[112:128],
                               np.zeros(40 + 22 + 2, np.int64)])
    crc_in = np.concatenate([even, odd_head])          # 114 + 82 = 196
    crc = pack_bits(crc_mod.crc24q_bits(crc_in), 24)
    odd = np.concatenate([odd_head, crc, np.zeros(8, np.int64)])
    assert even.size == 114 and odd.size == 114
    return even, odd


def parse_nominal_page(even114: np.ndarray, odd114: np.ndarray):
    """(even, odd) info bits -> (crc_ok, data128)."""
    even114 = np.asarray(even114, np.int64) & 1
    odd114 = np.asarray(odd114, np.int64) & 1
    if even114[0] != 0 or odd114[0] != 1:
        return False, None
    crc_in = np.concatenate([even114, odd114[:82]])
    want = unpack_u(odd114[82:106])
    ok = crc_mod.crc24q_bits(crc_in) == want
    data = np.concatenate([even114[2:114], odd114[2:18]])
    return ok, data


# --- word types 0-6: Keplerian eph + GST + GST-UTC (ICD 5.1.9) -----------

_PI = 3.1415926535898


def _word_fields(data: np.ndarray) -> tuple[int, dict]:
    wt = unpack_u(data[0:6])
    d = {}
    if wt == 0:
        # spare word with time: WN/TOW valid when the 2-bit time field
        # is 10b (ICD 4.3.5 table 49; bit layout sdrnav_gal.c:184-187 —
        # the reference reads it unconditionally, we gate on the flag)
        if unpack_u(data[6:8]) == 2:
            d["week"] = unpack_u(data[96:108])
            # TOW stamps the START of the 2 s page; +2 s = the edge the
            # anchor refers to (the reference's +2.0, sdrnav_gal.c:186)
            d["tow_s"] = float(unpack_u(data[108:128])) + 2.0
    elif wt == 1:
        d["iode"] = unpack_u(data[6:16])
        d["toe"] = unpack_u(data[16:30]) * 60.0
        d["m0"] = unpack_s(data[30:62]) * 2.0 ** -31 * _PI
        d["e"] = unpack_u(data[62:94]) * 2.0 ** -33
        d["sqrt_a"] = unpack_u(data[94:126]) * 2.0 ** -19
    elif wt == 2:
        d["iode"] = unpack_u(data[6:16])
        d["omega0"] = unpack_s(data[16:48]) * 2.0 ** -31 * _PI
        d["i0"] = unpack_s(data[48:80]) * 2.0 ** -31 * _PI
        d["omega"] = unpack_s(data[80:112]) * 2.0 ** -31 * _PI
        d["idot"] = unpack_s(data[112:126]) * 2.0 ** -43 * _PI
    elif wt == 3:
        d["iode"] = unpack_u(data[6:16])
        d["omega_dot"] = unpack_s(data[16:40]) * 2.0 ** -43 * _PI
        d["delta_n"] = unpack_s(data[40:56]) * 2.0 ** -43 * _PI
        d["cuc"] = unpack_s(data[56:72]) * 2.0 ** -29
        d["cus"] = unpack_s(data[72:88]) * 2.0 ** -29
        d["crc"] = unpack_s(data[88:104]) * 2.0 ** -5
        d["crs"] = unpack_s(data[104:120]) * 2.0 ** -5
    elif wt == 4:
        d["iode"] = unpack_u(data[6:16])
        d["cic"] = unpack_s(data[22:38]) * 2.0 ** -29
        d["cis"] = unpack_s(data[38:54]) * 2.0 ** -29
        d["toc"] = unpack_u(data[54:68]) * 60.0
        d["af0"] = unpack_s(data[68:99]) * 2.0 ** -34
        d["af1"] = unpack_s(data[99:120]) * 2.0 ** -46
        d["af2"] = unpack_s(data[120:126]) * 2.0 ** -59
    elif wt == 5:
        d["tgd"] = unpack_s(data[47:57]) * 2.0 ** -32      # BGD(E1,E5b)
        d["week"] = unpack_u(data[73:85])                  # GST WN
        d["tow_s"] = float(unpack_u(data[85:105]))         # GST TOW
    elif wt == 6:
        # GST-UTC conversion (ICD 5.1.7; the reference reads only the
        # trailing TOW, sdrnav_gal.c:160-172 — we decode the full set)
        d["utc"] = Utc(
            a0=unpack_s(data[6:38]) * 2.0 ** -30,
            a1=unpack_s(data[38:62]) * 2.0 ** -50,
            dt_ls=unpack_s(data[62:70]),
            t0t=unpack_u(data[70:78]) * 3600.0,
            wn0t=unpack_u(data[78:86]),
            wn_lsf=unpack_u(data[86:94]),
            dn=unpack_u(data[94:97]),
            dt_lsf=unpack_s(data[97:105]))
        d["tow_s"] = float(unpack_u(data[105:125])) + 2.0
    return wt, d


def _pack_word(wt: int, eph: Ephemeris) -> np.ndarray:
    data = np.zeros(128, np.int64)
    data[0:6] = pack_bits(wt, 6)
    if wt == 0:
        data[6:8] = pack_bits(2, 2)            # time field: WN/TOW valid
        data[96:108] = pack_bits(eph.week, 12)
        data[108:128] = pack_bits(max(int(eph.tow_s) - 2, 0), 20)
    elif wt == 6:
        u = eph.utc or Utc()
        data[6:38] = pack_bits(int(round(u.a0 / 2.0 ** -30)), 32)
        data[38:62] = pack_bits(int(round(u.a1 / 2.0 ** -50)), 24)
        data[62:70] = pack_bits(int(u.dt_ls), 8)
        data[70:78] = pack_bits(int(round(u.t0t / 3600.0)), 8)
        data[78:86] = pack_bits(int(u.wn0t), 8)
        data[86:94] = pack_bits(int(u.wn_lsf), 8)
        data[94:97] = pack_bits(int(u.dn), 3)
        data[97:105] = pack_bits(int(u.dt_lsf), 8)
        data[105:125] = pack_bits(max(int(eph.tow_s) - 2, 0), 20)
    elif wt == 1:
        data[6:16] = pack_bits(eph.iode, 10)
        data[16:30] = pack_bits(int(round(eph.toe / 60.0)), 14)
        data[30:62] = pack_bits(int(round(eph.m0 / _PI / 2.0 ** -31)), 32)
        data[62:94] = pack_bits(int(round(eph.e / 2.0 ** -33)), 32)
        data[94:126] = pack_bits(int(round(eph.sqrt_a / 2.0 ** -19)), 32)
    elif wt == 2:
        data[6:16] = pack_bits(eph.iode, 10)
        data[16:48] = pack_bits(int(round(eph.omega0 / _PI / 2.0 ** -31)),
                                32)
        data[48:80] = pack_bits(int(round(eph.i0 / _PI / 2.0 ** -31)), 32)
        data[80:112] = pack_bits(int(round(eph.omega / _PI / 2.0 ** -31)),
                                 32)
        data[112:126] = pack_bits(int(round(eph.idot / _PI / 2.0 ** -43)),
                                  14)
    elif wt == 3:
        data[6:16] = pack_bits(eph.iode, 10)
        data[16:40] = pack_bits(
            int(round(eph.omega_dot / _PI / 2.0 ** -43)), 24)
        data[40:56] = pack_bits(int(round(eph.delta_n / _PI / 2.0 ** -43)),
                                16)
        data[56:72] = pack_bits(int(round(eph.cuc / 2.0 ** -29)), 16)
        data[72:88] = pack_bits(int(round(eph.cus / 2.0 ** -29)), 16)
        data[88:104] = pack_bits(int(round(eph.crc / 2.0 ** -5)), 16)
        data[104:120] = pack_bits(int(round(eph.crs / 2.0 ** -5)), 16)
    elif wt == 4:
        data[6:16] = pack_bits(eph.iode, 10)
        data[22:38] = pack_bits(int(round(eph.cic / 2.0 ** -29)), 16)
        data[38:54] = pack_bits(int(round(eph.cis / 2.0 ** -29)), 16)
        data[54:68] = pack_bits(int(round(eph.toc / 60.0)), 14)
        data[68:99] = pack_bits(int(round(eph.af0 / 2.0 ** -34)), 31)
        data[99:120] = pack_bits(int(round(eph.af1 / 2.0 ** -46)), 21)
        data[120:126] = pack_bits(int(round(eph.af2 / 2.0 ** -59)), 6)
    elif wt == 5:
        data[47:57] = pack_bits(int(round(eph.tgd / 2.0 ** -32)), 10)
        data[73:85] = pack_bits(eph.week, 12)
        data[85:105] = pack_bits(int(eph.tow_s), 20)
    return data


def encode_inav_symbols(eph: Ephemeris,
                        word_types=(1, 2, 3, 4, 5)) -> np.ndarray:
    """Full symbol stream of nominal pages for the word sequence: one
    (even, odd) page pair per word, 500 symbols per word (2 s)."""
    out = []
    for wt in word_types:
        even, odd = build_nominal_page(_pack_word(wt, eph))
        out.append(encode_half_page(even))
        out.append(encode_half_page(odd))
    return np.concatenate(out)


WORD_CYCLE = (1, 2, 3, 4, 5)
PAGE_PAIR_SYMBOLS = 500        # even + odd half pages, 2 s at 250 sps
SYMBOL_RATE_SPS = 250.0


def encode_inav_stream(eph: Ephemeris, start_tow_s: float,
                       n_page_pairs: int) -> np.ndarray:
    """Continuous I/NAV symbol stream with live timing.

    Page pair i (2 s, word type WORD_CYCLE[i % 5]) starts at GST
    start_tow_s + 2*i; every word-5 page carries tow_s = the GST of its
    OWN even half-page's first symbol edge — the anchor contract
    decode_inav_stream recovers (the role GPS ToW-in-HOW plays for LNAV).
    """
    out = []
    for i in range(n_page_pairs):
        wt = WORD_CYCLE[i % len(WORD_CYCLE)]
        e = copy.copy(eph)
        e.tow_s = start_tow_s + 2.0 * i
        even, odd = build_nominal_page(_pack_word(wt, e))
        out.append(encode_half_page(even))
        out.append(encode_half_page(odd))
    return np.concatenate(out)


def decode_inav_stream(symbols: np.ndarray, prn: int = 0
                       ) -> tuple[Ephemeris, list[tuple[int, float]]]:
    """Symbol stream -> (Ephemeris, anchors).

    anchors: (symbol index of an even half-page's first symbol, GST tow_s
    at that edge) for every CRC-valid word-5 page — the transmit-time
    anchors observables need (sdrnav_gal.c GST→GPST role).
    """
    s = np.asarray(symbols, np.float64)
    eph = Ephemeris(prn=prn)
    have = []
    anchors: list[tuple[int, float]] = []
    halves: dict[int, np.ndarray] = {}
    n_off = s.size - 250 + 1
    if n_off > 0:
        # vectorized sync scan (both polarities, <=1 hard error) + ONE
        # batched Viterbi over every candidate body — the same decisions
        # decode_half_page(max_sync_errors=1) makes per offset, without
        # a Python call per offset or a trellis run per candidate
        hard = (s > 0.5).astype(np.int64)
        d_pos = (sliding_window_view(hard, 10)[:n_off]
                 ^ SYNC).sum(axis=-1)
        cand = np.nonzero(np.minimum(d_pos, 10 - d_pos) <= 1)[0]
        if cand.size:
            flip = ((10 - d_pos) < d_pos)[cand]
            bodies = sliding_window_view(s, 250)[cand][:, 10:]
            bodies = np.where(flip[:, None], 1.0 - bodies, bodies)
            deint = (bodies.reshape(-1, 8, 30).transpose(0, 2, 1)
                     .reshape(cand.size, 240))
            bits = fec.viterbi_decode_batch(deint, invert_g2=True,
                                            terminated=True)
            halves = {int(i): bits[j] for j, i in enumerate(cand)}
    for p1, h1 in sorted(halves.items()):
        h2 = halves.get(p1 + 250)
        if h2 is None or h1[0] != 0 or h2[0] != 1:
            continue
        ok, data = parse_nominal_page(h1, h2)
        if not ok:
            continue
        wt, fields = _word_fields(data)
        if not fields:
            continue
        for k, v in fields.items():
            setattr(eph, k, v)
        if wt == 5:
            anchors.append((p1, fields["tow_s"]))
        if wt not in have:
            have.append(wt)
    eph.have_subframes = tuple(sorted(have))
    return eph, anchors


def decode_inav_symbols(symbols: np.ndarray, prn: int = 0) -> Ephemeris:
    """Symbol stream (soft/hard, any alignment) -> Ephemeris.

    Scans for sync patterns at every offset (a sync match alone proves
    nothing — random data syncs ~2/1024 per offset — so no symbols are
    consumed on a match), decodes half pages, pairs even/odd by position,
    checks CRC, merges word fields (sdrnav_gal.c:20-275 role).
    """
    eph, _ = decode_inav_stream(symbols, prn=prn)
    return eph


def inav_complete(eph: Ephemeris) -> bool:
    return {1, 2, 3, 4} <= set(eph.have_subframes)
