"""The port's nav-message codecs vs the JAX package's: SBAS
(models/receiver/sbas.py), Galileo I/NAV (galileo.py) and GLONASS GNAV
(glonass.py).

Streams come from the encoders (equal between the packages, checked
first), are corrupted from a seed (noise, inverted polarity, a flipped sync
symbol, an odd offset, broken strings), and decoded by both. Everything is
bits, integers or fields decoded from them, so every comparison is exact:
the messages, the ephemeris records field by field, and the anchors.
"""
import copy
import dataclasses

import numpy as np
import pytest

from gps_jamming_tpu.models.receiver import galileo as jgal
from gps_jamming_tpu.models.receiver import glonass as jglo
from gps_jamming_tpu.models.receiver import lnav as jlnav
from gps_jamming_tpu.models.receiver import sbas as jsbas
from gps_jamming_tpu_torch.models.receiver import galileo as tgal
from gps_jamming_tpu_torch.models.receiver import glonass as tglo
from gps_jamming_tpu_torch.models.receiver import lnav as tlnav
from gps_jamming_tpu_torch.models.receiver import sbas as tsbas
from gps_jamming_tpu_torch.sim import constellation as tcon

TOE = 345600.0


def _fields(rec):
    """A decoded record as a dict of plain values (NamedTuples as tuples,
    arrays as lists), comparable across the two packages' classes."""
    out = {}
    for k, v in dataclasses.asdict(rec).items():
        if isinstance(v, np.ndarray):
            v = v.tolist()
        elif isinstance(v, tuple):
            v = tuple(v)
        out[k] = v
    return out


# --- SBAS ----------------------------------------------------------------------

def _mt12s(mod, n=3, week=310):
    return [mod.build_mt12(TOE + k, week, preamble_idx=k % 3)
            for k in range(n)]


def test_sbas_messages_and_stream_encode_as_jax():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 2, 212)
    for mt in (0, 9, 12, 63):
        np.testing.assert_array_equal(tsbas.build_message(mt, data, mt % 3),
                                      jsbas.build_message(mt, data, mt % 3))
    np.testing.assert_array_equal(tsbas.encode_stream(_mt12s(tsbas)),
                                  jsbas.encode_stream(_mt12s(jsbas)))


@pytest.mark.parametrize("offset,noise,seed", [(0, 0.0, 1), (6, 0.3, 2),
                                               (13, 0.3, 3), (8, 0.35, 4)])
def test_sbas_decode_stream_matches_jax(offset, noise, seed):
    """A noisy soft stream cut at an offset into the first message (odd:
    mid symbol pair): the same CRC-valid messages, offsets, MT12 ToW and
    week."""
    rng = np.random.default_rng(seed)
    sym = tsbas.encode_stream(_mt12s(tsbas, 4)).astype(np.float64)
    soft = np.clip(sym + noise * rng.standard_normal(sym.size), 0.0, 1.0)
    cut = soft[offset:]
    cut = cut[: cut.size - cut.size % 2]
    got = tsbas.decode_stream(cut)
    want = jsbas.decode_stream(cut)
    assert [_fields(m) for m in got] == [_fields(m) for m in want]
    assert all(m.mt == tsbas.MT12 and m.week == 310 for m in got)
    tows = [m.tow_s for m in got]
    if offset == 0:
        assert tows == [TOE + k for k in range(4)]
    elif offset % 2 == 0:
        assert tows and set(tows) <= {TOE + k for k in range(1, 4)}


# --- Galileo I/NAV -------------------------------------------------------------

def _gal_eph(mod):
    e = copy.copy(tcon.galileo_shell(TOE)[5])
    e = mod.Ephemeris(**dataclasses.asdict(e))
    e.utc = mod.UtcParams(a0=1.5e-9, a1=-2e-15, dt_ls=18, t0t=345600.0,
                          wn0t=44, wn_lsf=45, dn=3, dt_lsf=18)
    e.tow_s = TOE
    return e


@pytest.mark.parametrize("wt", [0, 1, 2, 3, 4, 5, 6])
def test_inav_words_and_pages_match_jax(wt):
    teph, jeph = _gal_eph(tlnav), _gal_eph(jlnav)
    data = tgal._pack_word(wt, teph)
    np.testing.assert_array_equal(data, jgal._pack_word(wt, jeph))
    t_wt, t_f = tgal._word_fields(data)
    j_wt, j_f = jgal._word_fields(data)
    assert t_wt == j_wt == wt
    assert {k: tuple(v) if isinstance(v, tuple) else v
            for k, v in t_f.items()} == \
        {k: tuple(v) if isinstance(v, tuple) else v for k, v in j_f.items()}
    even, odd = tgal.build_nominal_page(data)
    for a, b in zip((even, odd), jgal.build_nominal_page(data)):
        np.testing.assert_array_equal(a, b)
    assert tgal.parse_nominal_page(even, odd)[0]
    np.testing.assert_array_equal(tgal.parse_nominal_page(even, odd)[1],
                                  jgal.parse_nominal_page(even, odd)[1])
    bad = odd.copy()
    bad[40] ^= 1
    assert tgal.parse_nominal_page(even, bad)[0] == \
        jgal.parse_nominal_page(even, bad)[0] is False
    half = tgal.encode_half_page(even)
    np.testing.assert_array_equal(half, jgal.encode_half_page(even))
    for errs in (0, 1):
        h = half.astype(np.float64)
        h[3] = 1.0 - h[3]
        ok_t, bits_t = tgal.decode_half_page(h, max_sync_errors=errs)
        ok_j, bits_j = jgal.decode_half_page(h, max_sync_errors=errs)
        assert ok_t == ok_j == bool(errs)
        if errs:
            np.testing.assert_array_equal(bits_t, bits_j)
            np.testing.assert_array_equal(bits_t, even)
    sym = tgal.interleave(np.arange(240))
    np.testing.assert_array_equal(sym, jgal.interleave(np.arange(240)))
    np.testing.assert_array_equal(tgal.deinterleave(sym), np.arange(240))


@pytest.mark.parametrize("invert,noise,seed", [(False, 0.0, 1),
                                               (True, 0.0, 2),
                                               (False, 0.3, 3),
                                               (True, 0.35, 4)])
def test_inav_stream_decode_matches_jax(invert, noise, seed):
    """encode_inav_stream -> soft symbols (either polarity, one flipped
    sync symbol, noise, a 37-symbol lead-in) -> the same ephemeris and the
    same word-5 anchors in both packages."""
    rng = np.random.default_rng(seed)
    teph, jeph = _gal_eph(tlnav), _gal_eph(jlnav)
    sym = tgal.encode_inav_stream(teph, TOE - 4.0, 12)
    np.testing.assert_array_equal(
        sym, jgal.encode_inav_stream(jeph, TOE - 4.0, 12))
    np.testing.assert_array_equal(tgal.encode_inav_symbols(teph),
                                  jgal.encode_inav_symbols(jeph))
    s = sym.astype(np.float64)
    s[500 * 3 + 4] = 1.0 - s[500 * 3 + 4]        # a sync symbol of page 3
    if invert:
        s = 1.0 - s
    s = np.clip(s + noise * rng.standard_normal(s.size), 0.0, 1.0)
    s = np.concatenate([rng.random(37), s])
    got, g_anc = tgal.decode_inav_stream(s, prn=6)
    want, w_anc = jgal.decode_inav_stream(s, prn=6)
    assert _fields(got) == _fields(want)
    assert g_anc == w_anc
    assert tgal.inav_complete(got) == jgal.inav_complete(want) is True
    assert got.iode == teph.iode and got.sqrt_a == pytest.approx(
        teph.sqrt_a, abs=2.0 ** -19)
    # word 5 of pairs 4 and 9 (noise may take one): tow = TOE - 4 +
    # 2 * pair, at the first symbol of its even half
    want_anc = [(37 + 500 * p, TOE - 4.0 + 2.0 * p) for p in (4, 9)]
    assert g_anc and set(g_anc) <= set(want_anc)
    if noise == 0.0:
        assert g_anc == want_anc
    assert _fields(tgal.decode_inav_symbols(s, prn=6)) == _fields(got)


def test_inav_decode_of_short_and_empty_streams_matches_jax():
    for s in (np.zeros(0), np.zeros(249), np.ones(600) * 0.5):
        got, g_anc = tgal.decode_inav_stream(s, prn=2)
        want, w_anc = jgal.decode_inav_stream(s, prn=2)
        assert _fields(got) == _fields(want) and g_anc == w_anc == []
        assert not tgal.inav_complete(got)


# --- GLONASS GNAV --------------------------------------------------------------

def _glo_eph(mod):
    g = tcon.glonass_shell((50.06, 19.94, 219.0), 27000.0)[3]
    g = mod.GloEphemeris(**dataclasses.asdict(g))
    g.acc_mps2 = (1.2e-6, -3.1e-6, 4.0e-7)
    g.gamma = -3.0e-11
    return g


def test_gnav_strings_and_kx_match_jax():
    rng = np.random.default_rng(9)
    for _ in range(20):
        d = rng.integers(0, 2, 77)
        np.testing.assert_array_equal(tglo.kx_checksum(d),
                                      jglo.kx_checksum(d))
        s = tglo.encode_string(d)
        np.testing.assert_array_equal(s, jglo.encode_string(d))
        assert tglo.check_string(s)[0] and jglo.check_string(s)[0]
        # every single-bit corruption fails the KX check in both
        for pos in rng.choice(85, 6, replace=False):
            bad = s.copy()
            bad[pos] ^= 1
            ok_t, d_t = tglo.check_string(bad)
            ok_j, d_j = jglo.check_string(bad)
            assert ok_t == ok_j is False
            np.testing.assert_array_equal(d_t, d_j)
    teph, jeph = _glo_eph(tglo), _glo_eph(jglo)
    for a, b in zip(tglo.encode_eph_strings(teph),
                    jglo.encode_eph_strings(jeph)):
        np.testing.assert_array_equal(a, b)
    strs = tglo.encode_eph_strings(teph)
    assert _fields(tglo.decode_strings(strs, 1)) == \
        _fields(jglo.decode_strings(strs, 1))
    np.testing.assert_array_equal(tglo.bits_to_symbols(strs),
                                  jglo.bits_to_symbols(strs))


@pytest.mark.parametrize("invert,n_err,seed", [(False, 0, 1), (True, 0, 2),
                                               (False, 3, 3), (True, 12, 4)])
def test_gnav_stream_decode_matches_jax(invert, n_err, seed):
    """encode_gnav_stream -> line symbols (either polarity, n_err random
    symbol errors, a 23-symbol lead-in) -> the same GloEphemeris, strings
    and time-mark anchors in both packages."""
    rng = np.random.default_rng(seed)
    teph, jeph = _glo_eph(tglo), _glo_eph(jglo)
    sym = tglo.encode_gnav_stream(teph, 27024.0, 3)
    np.testing.assert_array_equal(
        sym, jglo.encode_gnav_stream(jeph, 27024.0, 3))
    s = sym.copy()
    err = rng.choice(s.size, n_err, replace=False)
    s[err] ^= 1
    if invert:
        s ^= 1
    s = np.concatenate([rng.integers(0, 2, 23), s])
    got, g_anc = tglo.decode_gnav_stream(s, freq_ch=1)
    want, w_anc = jglo.decode_gnav_stream(s, freq_ch=1)
    assert _fields(got) == _fields(want)
    assert g_anc == w_anc
    t_pos = tglo.symbols_to_strings_pos(s)
    j_pos = jglo.symbols_to_strings_pos(s)
    assert [p for p, _ in t_pos] == [p for p, _ in j_pos]
    for (_, a), (_, b) in zip(t_pos, j_pos):
        np.testing.assert_array_equal(a, b)
    assert len(tglo.symbols_to_strings(s)) == len(t_pos)
    if n_err == 0:
        assert got.complete
        assert g_anc == [(23 + 800 * c, 27024.0 + 8.0 * c)
                         for c in range(3)]
