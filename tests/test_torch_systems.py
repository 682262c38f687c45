"""The port's per-system adapters (models/receiver/systems.py) and the
Galileo and GLONASS renderers (sim/constellation.py) vs the JAX package's,
with no sample-rate work.

- Observables from synthetic prompt streams: the encoders' full nav
  streams (13 s of I/NAV at 4 ms epochs, 11 s of GNAV at 1 ms epochs, 4.2 s
  of SBAS at 1 ms epochs) as +/-A prompt values plus seeded noise, and a
  code remainder advancing at a constant chip rate. Decoded ephemerides,
  anchors and messages are exact; the chip counts float64 to rtol 1e-12.
- `glonass_sat_pos_clock` on the closed-loop tests' 5-satellite shell:
  states and clocks float64 to rtol 1e-12; an empty list gives empty
  arrays (ROADMAP C9), where the JAX package raises.
- The renderers at 20 ms (rtol 1e-9) and the fixture shells (exact).
"""
import dataclasses

import numpy as np
import pytest

from gps_jamming_tpu.models.receiver import galileo as jgal
from gps_jamming_tpu.models.receiver import glonass as jglo
from gps_jamming_tpu.models.receiver import sbas as jsbas
from gps_jamming_tpu.models.receiver import systems as jsys
from gps_jamming_tpu.sim import constellation as jcon
from gps_jamming_tpu_torch.models.receiver import galileo as tgal
from gps_jamming_tpu_torch.models.receiver import glonass as tglo
from gps_jamming_tpu_torch.models.receiver import sbas as tsbas
from gps_jamming_tpu_torch.models.receiver import systems as tsys
from gps_jamming_tpu_torch.sim import constellation as tcon
from tests.test_multiconstellation_e2e import RX_LLA, TOE, _gal_shell, \
    _glo_shell

GLO_T0, GLO_TB = 27030.0, 27000.0


def _plain(rec):
    """A record's fields as plain values, comparable across packages."""
    return {k: (tuple(v) if isinstance(v, tuple)
                else v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in dataclasses.asdict(rec).items()}


def _code_rem(n_epochs, code_len, chips_per_epoch, rem0):
    """Code phase at each window start, chips mod code_len: a constant
    chip rate of `chips_per_epoch` (a little off one period)."""
    k = np.arange(n_epochs, dtype=np.float64)
    return ((rem0 + k * chips_per_epoch) % code_len).astype(np.float32)


def _same_obs(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    assert _plain(got.eph) == _plain(want.eph)
    assert got.prn == want.prn
    assert got.anchor_chip == want.anchor_chip
    assert got.anchor_tow == want.anchor_tow
    assert got.sync_quality == want.sync_quality
    assert got.chip_rate_hz == want.chip_rate_hz
    np.testing.assert_allclose(got.chips, want.chips, rtol=1e-12)
    np.testing.assert_array_equal(got.cn0_dbhz, want.cn0_dbhz)
    np.testing.assert_array_equal(got.doppler_hz, want.doppler_hz)
    for e in (0, 1000, got.chips.size - 1):
        assert got.transmit_time(e) == pytest.approx(
            want.transmit_time(e), rel=1e-15)


def _gal_stream(seed, lead, noise):
    """13 s of I/NAV prompts (3250 epochs of 4 ms): `lead` epochs of
    noise, then the word cycle from a page boundary, +A for symbol 0."""
    rng = np.random.default_rng(seed)
    eph = _gal_shell()[7]
    sym = tgal.encode_inav_stream(eph, TOE - 2.0, 7)
    n = 3250
    ip = np.concatenate([rng.standard_normal(lead),
                         1.0 - 2.0 * sym.astype(np.float64)])[:n]
    ip = (1.0 * ip + noise * rng.standard_normal(n)).astype(np.float32)
    rem = _code_rem(n, tgal.BOC_LEN, tgal.BOC_LEN * (1 + 2.1e-6), 17.25)
    cf = (1500.0 + rng.standard_normal(n)).astype(np.float32)
    cn0 = (45.0 + rng.standard_normal(n)).astype(np.float32)
    return eph, ip, rem, cf, cn0


@pytest.mark.parametrize("lead,noise,skip", [(0, 0.0, 0), (123, 0.3, 150),
                                             (57, 0.4, 250)])
def test_galileo_observables_match_jax(lead, noise, skip):
    eph, ip, rem, cf, cn0 = _gal_stream(lead, lead, noise)
    kw = dict(i_prompt=ip, code_rem=rem, carr_freq=cf, cn0=cn0,
              skip_epochs=skip, sample_offset=321.0, epoch_samples=16384)
    got = tsys.build_galileo_observables(prn=8, **kw)
    want = jsys.build_galileo_observables(prn=8, **kw)
    _same_obs(got, want)
    assert got is not None and tgal.inav_complete(got.eph)
    assert got.eph.iode == eph.iode and got.eph.week == eph.week
    # the anchor lies on a code-period boundary, at a word-5 page's GST
    assert got.anchor_chip % tgal.BOC_LEN == 0
    assert (got.anchor_tow - (TOE - 2.0)) % 10.0 == 8.0
    # too short a stream decodes nothing, in both
    kw.update(i_prompt=ip[:1500], code_rem=rem[:1500])
    assert tsys.build_galileo_observables(prn=8, **kw) is None
    assert jsys.build_galileo_observables(prn=8, **kw) is None


def _glo_stream(seed, phase, noise):
    """11 s of GNAV prompts (11 000 epochs of 1 ms, 10 per line symbol):
    the symbol grid starts at epoch `phase`, +A for symbol 0."""
    rng = np.random.default_rng(seed)
    g = _glo_shell(GLO_T0, GLO_TB)[2]
    sym = tglo.encode_gnav_stream(g, GLO_T0 - 6.0, 2)
    n = 11000
    chips = np.repeat(1.0 - 2.0 * sym.astype(np.float64), 10)
    ip = np.concatenate([rng.standard_normal(phase), chips])[:n]
    ip = (ip + noise * rng.standard_normal(n)).astype(np.float32)
    rem = _code_rem(n, 511, 511 * (1 - 1.3e-6), 300.5)
    cf = (2500.0 + rng.standard_normal(n)).astype(np.float32)
    cn0 = (47.0 + rng.standard_normal(n)).astype(np.float32)
    return g, ip, rem, cf, cn0


@pytest.mark.parametrize("phase,noise,skip", [(0, 0.0, 0), (3, 0.25, 600),
                                              (7, 0.35, 1000)])
def test_glonass_observables_match_jax(phase, noise, skip):
    g, ip, rem, cf, cn0 = _glo_stream(phase, phase, noise)
    kw = dict(i_prompt=ip, code_rem=rem, carr_freq=cf, cn0=cn0,
              skip_epochs=skip, sample_offset=77.0, epoch_samples=10000)
    got = tsys.build_glonass_observables(freq_ch=0, **kw)
    want = jsys.build_glonass_observables(freq_ch=0, **kw)
    _same_obs(got, want)
    assert got is not None and got.eph.complete
    assert got.eph.tau_s == pytest.approx(g.tau_s, abs=2.0 ** -30)
    assert got.anchor_chip % 511 == 0
    assert (got.anchor_tow - (GLO_T0 - 6.0)) % 8.0 == 0.0
    # no symbol sync in pure noise: None in both
    rng = np.random.default_rng(5)
    kw.update(i_prompt=rng.standard_normal(11000).astype(np.float32))
    assert tsys.build_glonass_observables(freq_ch=0, **kw) is None
    assert jsys.build_glonass_observables(freq_ch=0, **kw) is None


@pytest.mark.parametrize("phase,invert,noise", [(0, False, 0.0),
                                                (1, True, 0.3),
                                                (1, False, 0.4)])
def test_decode_sbas_channel_matches_jax(phase, invert, noise):
    """4.2 s of SBAS prompts (2 epochs per 500 sps symbol, '1' -> +A, the
    JAX test's convention): the same messages from both packages."""
    rng = np.random.default_rng(11 + phase)
    msgs = [tsbas.build_mt12(TOE + k, 310, preamble_idx=k % 3)
            for k in range(3)]
    sym = tsbas.encode_stream(msgs)
    pm = np.repeat(2.0 * sym - 1.0, 2) * (-1.0 if invert else 1.0)
    ip = np.concatenate([rng.standard_normal(250 + phase), pm,
                         rng.standard_normal(4200)])[:4200]
    ip = (ip + noise * rng.standard_normal(4200)).astype(np.float32)
    got = tsys.decode_sbas_channel(ip, skip_epochs=300)
    want = jsys.decode_sbas_channel(ip, skip_epochs=300)
    assert [_plain(m) for m in got] == [_plain(m) for m in want]
    mt12 = [m for m in got if m.mt == tsbas.MT12]
    assert mt12 and all(m.week == 310 for m in mt12)
    assert {m.tow_s for m in mt12} <= {TOE + k for k in range(3)}
    assert type(got[0]).__name__ == type(want[0]).__name__ == "SbasMessage"
    assert tsys.decode_sbas_channel(ip[:600], skip_epochs=300) == \
        jsys.decode_sbas_channel(ip[:600], skip_epochs=300) == []


def _to_port(g):
    return tglo.GloEphemeris(**dataclasses.asdict(g))


def test_glonass_sat_pos_clock_matches_jax():
    sats = _glo_shell(GLO_T0, GLO_TB)
    for g in sats:
        g.acc_mps2 = (2e-6, -1e-6, 3e-6)
        g.gamma = 1e-11
    t_tx = GLO_T0 + np.array([0.071, 0.068, 0.075, 0.080, 0.066]) \
        + np.arange(5) * 3.7
    pos, clk = tsys.glonass_sat_pos_clock([_to_port(g) for g in sats], t_tx)
    j_pos, j_clk = jsys.glonass_sat_pos_clock(sats, t_tx)
    np.testing.assert_allclose(pos, j_pos, rtol=1e-12)
    np.testing.assert_allclose(clk, j_clk, rtol=1e-12)
    assert pos.shape == (5, 3) and clk.shape == (5,)


def test_glonass_sat_pos_clock_of_no_satellites_is_empty():
    """ROADMAP C9: the port returns empty arrays where the JAX package's
    np.stack raises on an empty list."""
    pos, clk = tsys.glonass_sat_pos_clock([], np.zeros(0))
    assert pos.shape == (0, 3) and clk.shape == (0,)
    with pytest.raises(ValueError):
        jsys.glonass_sat_pos_clock([], np.zeros(0))


def test_shells_equal_the_jax_tests():
    assert [_plain(e) for e in tcon.galileo_shell(TOE)] == \
        [_plain(e) for e in _gal_shell()]
    assert [_plain(e) for e in tcon.glonass_shell(RX_LLA, GLO_TB)] == \
        [_plain(e) for e in _glo_shell(GLO_T0, GLO_TB)]


def test_galileo_renderer_matches_jax():
    fs = 4.096e6
    n = int(0.02 * fs)
    got = tcon.simulate_galileo_constellation(
        tcon.galileo_shell(TOE), RX_LLA, TOE - 1.3, n, fs, noise_std=0.4,
        seed=2)
    want = jcon.simulate_galileo_constellation(
        _gal_shell(), RX_LLA, TOE - 1.3, n, fs, noise_std=0.4, seed=2)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-9, atol=1e-9)
    assert [dataclasses.astuple(t) for t in got[1]] == pytest.approx(
        [dataclasses.astuple(t) for t in want[1]], rel=1e-12)
    assert len(got[1]) >= 4
    np.testing.assert_allclose(got[2], want[2], rtol=1e-15)


def test_glonass_renderer_matches_jax():
    fs = 10e6
    n = int(0.02 * fs)
    got = tcon.simulate_glonass_constellation(
        tcon.glonass_shell(RX_LLA, GLO_TB), RX_LLA, GLO_T0, n, fs,
        noise_std=0.4, seed=4)
    want = jcon.simulate_glonass_constellation(
        _glo_shell(GLO_T0, GLO_TB), RX_LLA, GLO_T0, n, fs, noise_std=0.4,
        seed=4)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-9, atol=1e-9)
    assert [dataclasses.astuple(t) for t in got[1]] == pytest.approx(
        [dataclasses.astuple(t) for t in want[1]], rel=1e-12)
    assert len(got[1]) == 5
    r = np.array([t.range_m for t in got[1]])
    np.testing.assert_allclose(
        tcon.glo_geometric_range(tcon.glonass_shell(RX_LLA, GLO_TB)[0],
                                 np.array([GLO_T0, GLO_T0 + 1.0]), got[2]),
        jcon.glo_geometric_range(_glo_shell(GLO_T0, GLO_TB)[0],
                                 np.array([GLO_T0, GLO_T0 + 1.0]), want[2]),
        rtol=1e-12)
    assert r.min() > 1.9e7
