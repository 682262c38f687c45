"""GLONASS L1OF: FDMA acquisition and the GNAV string codec (counterpart
of gps_jamming_tpu.models.receiver.glonass; the codec is a NumPy copy,
held equal by tests/test_torch_decoders.py).

All 14 FDMA channels share one 511-chip code and differ by carrier
(k * 562.5 kHz, k = -7..6, sdrinit.c:391-399). Two searches over
(channel x Doppler x lag), both plain torch (cuFFT on the card), as the
JAX package left both to XLA:
- 'pcf': `caf.caf_accumulate_pcf_fdma`, sub-bin mixes per channel and
  integer shifts of the shared replica spectrum;
- 'std': `caf.caf_surface` over one flattened (channel, Doppler) frequency
  axis, summed over the code periods.

GNAV timing (the reference's `sdrnav_glo.c:26-229`): 100 sps line symbols
= 50 bps data x a 100 Hz meander; each 2 s string is 1.7 s (170 symbols)
of data and a 0.3 s time mark (30 symbols). The KX check is the ICD's
modified Hamming code over bit positions 1..85 (check bits at 1..8; group
i covers the data positions whose binary code has bit i-1 set; bit 8 is
the overall parity).
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from ...config import AcquisitionConfig
from ...utils import constants as C
from ...ops import caf as caf_ops
from ...ops import codes as codes_ops
from . import acquisition as acq_mod

# the reference's 14 channels (sdrinit.c:41-107): frequency numbers -7..+6
FREQ_CHANNELS = tuple(range(-7, 7))
STRING_SECONDS = 2.0
DATA_SYMBOLS = 170            # 1.7 s at 100 sps
MARK_SYMBOLS = 30
# 30-symbol time mark (ICD: 111110001101110101000010010110)
TIME_MARK = np.array([1, 1, 1, 1, 1, 0, 0, 0, 1, 1, 0, 1, 1, 1, 0, 1, 0,
                      1, 0, 0, 0, 0, 1, 0, 0, 1, 0, 1, 1, 0], np.int64)


def channel_offsets_hz(center_freq_hz: float = C.GLO_G1_BASE_FREQ_HZ,
                       channels=FREQ_CHANNELS) -> np.ndarray:
    """Baseband carrier offset of each FDMA channel after the front end
    mixes down by `center_freq_hz`."""
    return np.array([C.GLO_G1_BASE_FREQ_HZ + k * C.GLO_G1_CH_SPACING_HZ
                     - center_freq_hz for k in channels], np.float64)


def replica_table_host(sample_rate: float,
                       n_samples: int) -> tuple[np.ndarray, np.ndarray]:
    """(1, n) conj-FFT replica planes of the shared 511-chip code."""
    return codes_ops.sampled_code_fft_conj_host(
        codes_ops.glonass_code()[None, :], C.GLO_CHIP_RATE_HZ, sample_rate,
        n_samples)


def acquire_all(blocks: torch.Tensor, sample_rate: float,
                cfg: AcquisitionConfig,
                center_freq_hz: float = C.GLO_G1_BASE_FREQ_HZ,
                channels=FREQ_CHANNELS,
                method: str = "auto") -> acq_mod.AcquisitionResult:
    """Acquisition over (FDMA channel x Doppler x lag).

    blocks: (n_intg, n) complex64 at `sample_rate`, centred on
    `center_freq_hz`. method 'auto' takes 'pcf' when the blocks split into
    two coherent groups and the configured step is at least 100 Hz (the
    PCF grid's worst interior spacing), else 'std'. Returns an
    AcquisitionResult over `channels`, with doppler_hz relative to each
    channel's carrier. A channel at the same lag as a far stronger acquired
    one is that channel's sidelobe leakage and is vetoed (`_nearfar_veto`).
    """
    nb, n = blocks.shape
    offsets = channel_offsets_hz(center_freq_hz, channels)
    rep = codes_ops.replica_tensor(replica_table_host(sample_rate, n),
                                   blocks.device)
    n_groups = 2
    if method == "auto":
        method = ("pcf" if nb % n_groups == 0
                  and cfg.doppler_step_hz >= 100.0 else "std")
    if method == "pcf":
        surf = caf_ops.caf_accumulate_pcf_fdma(
            blocks, rep, offsets, sample_rate,
            max_doppler_hz=cfg.doppler_max_hz, n_groups=n_groups)
        freqs = torch.from_numpy(caf_ops.pcf_doppler_hz(
            sample_rate, n, cfg.doppler_max_hz)).to(blocks.device)
        res = acq_mod.acquisition_test(
            surf, freqs, sample_rate, cfg,
            code_period_s=1e-3 * max(nb // n_groups, 1),
            code_len_chips=511.0)
        return _nearfar_veto(res, n)
    if method != "std":
        raise ValueError(f"unknown acquisition method {method!r}")
    dopp = caf_ops.doppler_bins(cfg.doppler_max_hz, cfg.doppler_step_hz)
    freqs = (offsets[:, None] + dopp[None, :]).astype(np.float32).ravel()
    surf = caf_ops.caf_surface(blocks, rep, freqs, sample_rate)
    surf = surf.sum(dim=0)[0].reshape(len(channels), dopp.size, n)
    res = acq_mod.acquisition_test(
        surf, torch.from_numpy(dopp).to(blocks.device), sample_rate, cfg,
        code_period_s=1e-3, code_len_chips=511.0)
    return _nearfar_veto(res, n)


def _nearfar_veto(res: acq_mod.AcquisitionResult, n: int,
                  dominance: float = 100.0,
                  lag_chips: float = 6.0) -> acq_mod.AcquisitionResult:
    """Drop FDMA near-far ghosts: a channel whose peak is `dominance` times
    below an acquired channel's at (circularly) the same lag, within
    `lag_chips`, is that channel's leakage through the shared code."""
    lag_samps = lag_chips * n / 511.0
    acq = res.acquired
    peak = res.peak_power
    lag = res.code_phase.to(torch.float32)
    d = (lag[:, None] - lag[None, :]).abs()
    circ = torch.minimum(d, n - d)
    dominated = (acq[None, :] & (peak[None, :] > peak[:, None] * dominance)
                 & (circ < lag_samps))
    return res._replace(acquired=acq & ~dominated.any(dim=1))


# ---------------------------------------------------------------------------
# GNAV string encode/decode (host numpy)
# ---------------------------------------------------------------------------

def _kx_groups():
    """Data-bit positions (9..85) covered by each of C1..C7."""
    groups = []
    for i in range(7):
        groups.append([p for p in range(9, 86) if (p >> i) & 1])
    return groups


_KX = _kx_groups()


def kx_checksum(data77: np.ndarray) -> np.ndarray:
    """8 check bits for the 77 data bits (positions 9..85, MSB=85 first in
    transmit order; here data77[0] = position 85 ... data77[76] = 9)."""
    bit_at = {85 - i: int(b) for i, b in enumerate(np.asarray(data77) & 1)}
    c = np.zeros(8, np.int64)
    for i in range(7):
        c[i] = np.bitwise_xor.reduce([bit_at[p] for p in _KX[i]])
    c[7] = (np.bitwise_xor.reduce([bit_at[p] for p in range(9, 86)])
            ^ np.bitwise_xor.reduce(c[:7]))
    return c


def encode_string(data77: np.ndarray) -> np.ndarray:
    """85-bit string in transmit order: data (pos 85..9) + KX (pos 8..1)."""
    data77 = np.asarray(data77, np.int64) & 1
    c = kx_checksum(data77)
    return np.concatenate([data77, c[::-1]])


def check_string(bits85: np.ndarray):
    """KX verify; returns (ok, data77)."""
    bits85 = np.asarray(bits85, np.int64) & 1
    data77 = bits85[:77]
    ok = bool(np.array_equal(encode_string(data77), bits85))
    return ok, data77


@dataclasses.dataclass
class GloEphemeris:
    """GLONASS broadcast state (strings 1-4) in PZ-90 ECEF, SI units."""
    freq_ch: int = 0
    tb_s: float = 0.0            # frame time within day
    tk_s: float = 0.0
    pos_m: tuple = (0.0, 0.0, 0.0)
    vel_mps: tuple = (0.0, 0.0, 0.0)
    acc_mps2: tuple = (0.0, 0.0, 0.0)
    tau_s: float = 0.0           # SV clock bias
    gamma: float = 0.0           # relative freq bias
    have_strings: tuple = ()

    @property
    def complete(self) -> bool:
        return {1, 2, 3, 4} <= set(self.have_strings)


def _sgn_mag(bits: np.ndarray, scale: float) -> float:
    """GLONASS sign-magnitude field: MSB = sign."""
    mag = 0
    for b in bits[1:]:
        mag = (mag << 1) | int(b)
    return (-mag if bits[0] else mag) * scale


def _pack_sgn_mag(value: float, width: int, scale: float) -> np.ndarray:
    mag = int(round(abs(value) / scale))
    out = np.zeros(width, np.int64)
    out[0] = 1 if value < 0 else 0
    for i in range(width - 1):
        out[width - 1 - i] = (mag >> i) & 1
    return out


def _pack_u(value: int, width: int) -> np.ndarray:
    return np.array([(int(value) >> (width - 1 - i)) & 1
                     for i in range(width)], np.int64)


def _u(bits) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


# String layout within the 77 data bits (index 0 = position 85 =
# transmit-first). Field WIDTHS and SCALES follow the GLONASS ICD /
# sdrnav_glo.c:26-199 (coords 2^-11 km sign-magnitude 27 bits, vel 2^-20
# km/s 24 bits, acc 2^-30 km/s^2 5 bits, tb 15-min units 7 bits, tk
# 5 h + 6 min + 1 half-minute bits, tau 2^-30 s 22 bits, gamma 2^-40
# 11 bits); field POSITIONS are framework-canonical (the simulator and
# decoder share them; over-the-air ICD bit positions can be swapped in
# without touching the field math):
#   all strings: d[0:4] = string number m
#   m=1..3: vel d[9:33], acc d[33:38], pos d[38:65]  (x/y/z for m=1/2/3)
#   m=1 adds tk seconds (17 bits: high d[4:9], low d[65:77]);
#   m=2 adds tb d[65:72]
#   m=4: tau d[4:26], gamma d[26:37]

_POS_SCALE = 2.0 ** -11 * 1e3
_VEL_SCALE = 2.0 ** -20 * 1e3
_ACC_SCALE = 2.0 ** -30 * 1e3


def encode_eph_strings(eph: GloEphemeris) -> list[np.ndarray]:
    """Strings 1-4 (85 bits each, transmit order) for the simulator."""
    out = []
    for m in (1, 2, 3, 4):
        d = np.zeros(77, np.int64)
        d[0:4] = _pack_u(m, 4)
        i = m - 1
        if m <= 3:
            d[9:33] = _pack_sgn_mag(eph.vel_mps[i], 24, _VEL_SCALE)
            d[33:38] = _pack_sgn_mag(eph.acc_mps2[i], 5, _ACC_SCALE)
            d[38:65] = _pack_sgn_mag(eph.pos_m[i], 27, _POS_SCALE)
        if m == 1:
            # framework-canonical tk: 17 bits of whole seconds split across
            # the spare d[4:9] (high) + d[65:77] (low) fields — the ICD's
            # 30 s hh/mm/half-min tk cannot timestamp our 2 s string
            # cadence (real GLONASS anchors strings within 30 s frames;
            # the field MATH is unchanged, only the packing is canonical)
            tk = int(round(eph.tk_s)) & 0x1FFFF
            d[4:9] = _pack_u(tk >> 12, 5)
            d[65:77] = _pack_u(tk & 0xFFF, 12)
        if m == 2:
            d[65:72] = _pack_u(int(eph.tb_s // 900), 7)
        if m == 4:
            d[4:26] = _pack_sgn_mag(eph.tau_s, 22, 2.0 ** -30)
            d[26:37] = _pack_sgn_mag(eph.gamma, 11, 2.0 ** -40)
        out.append(encode_string(d))
    return out


def decode_strings(strings: list[np.ndarray],
                   freq_ch: int = 0) -> GloEphemeris:
    """Decode KX-verified strings 1-4 into a GloEphemeris."""
    eph = GloEphemeris(freq_ch=freq_ch)
    have = []
    pos = [0.0, 0.0, 0.0]
    vel = [0.0, 0.0, 0.0]
    acc = [0.0, 0.0, 0.0]
    for s in strings:
        ok, d = check_string(s)
        if not ok:
            continue
        m = _u(d[0:4])
        if m < 1 or m > 4:
            continue
        if m <= 3:
            vel[m - 1] = _sgn_mag(d[9:33], _VEL_SCALE)
            acc[m - 1] = _sgn_mag(d[33:38], _ACC_SCALE)
            pos[m - 1] = _sgn_mag(d[38:65], _POS_SCALE)
        if m == 1:
            eph.tk_s = float((_u(d[4:9]) << 12) | _u(d[65:77]))
        if m == 2:
            eph.tb_s = _u(d[65:72]) * 900.0
        if m == 4:
            eph.tau_s = _sgn_mag(d[4:26], 2.0 ** -30)
            eph.gamma = _sgn_mag(d[26:37], 2.0 ** -40)
        if m not in have:
            have.append(m)
    eph.pos_m = tuple(pos)
    eph.vel_mps = tuple(vel)
    eph.acc_mps2 = tuple(acc)
    eph.have_strings = tuple(sorted(have))
    return eph


def symbols_to_strings_pos(symbols01: np.ndarray,
                           max_mark_errors: int = 1
                           ) -> list[tuple[int, np.ndarray]]:
    """Line symbols (100 sps, 0/1 hard decisions) -> [(time-mark start
    index, 85-bit string)].

    Time-mark correlation locates string boundaries (sdrnav_glo.c time
    mark search, both polarities, up to `max_mark_errors` symbol errors —
    the KX check is the real validator); each following 170 data symbols
    de-meander (pairs [d, ~d]) into 85 bits.
    """
    sym = np.asarray(symbols01, np.int64) & 1
    n = sym.size
    mark = TIME_MARK
    out = []
    for start in range(0, n - (MARK_SYMBOLS + DATA_SYMBOLS) + 1):
        w = sym[start:start + MARK_SYMBOLS]
        d_pos = int(np.sum(w ^ mark))
        d_neg = MARK_SYMBOLS - d_pos
        if min(d_pos, d_neg) > max_mark_errors:
            continue
        flip = 1 if d_neg < d_pos else 0
        data = sym[start + MARK_SYMBOLS:
                   start + MARK_SYMBOLS + DATA_SYMBOLS] ^ flip
        pairs = data.reshape(85, 2)
        # meander: symbol pair (b, ~b) encodes bit b; tolerate a few
        # broken pairs as long as the KX check of the result passes
        if int(np.sum(pairs[:, 0] ^ pairs[:, 1] != 1)) > 4:
            continue
        bits = pairs[:, 0]
        if check_string(bits)[0]:
            out.append((start, bits))
    return out


def symbols_to_strings(symbols01: np.ndarray):
    """KX-checked strings without positions (compatibility form)."""
    return [s for _, s in symbols_to_strings_pos(symbols01)]


STRING_SYMBOLS = MARK_SYMBOLS + DATA_SYMBOLS     # 200 symbols = 2 s
SYMBOL_RATE_SPS = 100.0
CYCLE_STRINGS = (1, 2, 3, 4)


def encode_gnav_stream(eph: GloEphemeris, start_tk_s: float,
                       n_cycles: int) -> np.ndarray:
    """Continuous GNAV line-symbol stream with live timing.

    Cycle c (8 s) sends strings 1-4; string m starts at
    start_tk_s + 8c + 2(m-1), and each cycle's string 1 carries
    tk = its OWN time-mark start second — the anchor contract
    decode_gnav_stream recovers.
    """
    out = []
    for c in range(n_cycles):
        e = copy.copy(eph)
        e.tk_s = start_tk_s + 8.0 * c
        out.append(bits_to_symbols(encode_eph_strings(e)))
    return np.concatenate(out)


def decode_gnav_stream(symbols01: np.ndarray, freq_ch: int = 0
                       ) -> tuple[GloEphemeris, list[tuple[int, float]]]:
    """Symbol stream -> (GloEphemeris, anchors).

    anchors: (symbol index of a string-1 time-mark start, tk_s at that
    edge) — the GLONASS transmit-time anchors (sdrnav_glo.c role).
    """
    found = symbols_to_strings_pos(symbols01)
    eph = decode_strings([s for _, s in found], freq_ch=freq_ch)
    anchors = []
    for pos, s in found:
        ok, d = check_string(s)
        if ok and _u(d[0:4]) == 1:
            tk = float((_u(d[4:9]) << 12) | _u(d[65:77]))
            anchors.append((pos, tk))
    return eph, anchors


def bits_to_symbols(strings: list[np.ndarray]) -> np.ndarray:
    """Simulator side: strings -> line symbols with meander + time marks."""
    out = []
    for s in strings:
        pairs = np.stack([s, s ^ 1], axis=1).reshape(-1)
        out.append(np.concatenate([TIME_MARK, pairs]))
    return np.concatenate(out)
