"""The port's NumPy host layers of the receiver vs the JAX package.

lnav, ephemeris, observables, pvt and the GPS constellation simulator are
NumPy copies in the port (the JAX package's receiver package imports jax).
The same inputs go through both; every result must be equal to 1e-9
relative (the code is the same float64 NumPy, so any larger difference is
a copying fault).
"""
import dataclasses

import numpy as np
import pytest

from gps_jamming_tpu.models.receiver import ephemeris as jeph
from gps_jamming_tpu.models.receiver import lnav as jlnav
from gps_jamming_tpu.models.receiver import observables as jobs
from gps_jamming_tpu.models.receiver import pvt as jpvt
from gps_jamming_tpu.sim import constellation as jcon
from gps_jamming_tpu_torch.models.receiver import ephemeris as teph
from gps_jamming_tpu_torch.models.receiver import lnav as tlnav
from gps_jamming_tpu_torch.models.receiver import observables as tobs
from gps_jamming_tpu_torch.models.receiver import pvt as tpvt
from gps_jamming_tpu_torch.sim import constellation as tcon

RTOL = 1e-9
FS = 2.048e6
RX_LLA = (50.06, 19.94, 219.0)
TOE = 345600.0


def _shell(lnav, n=24):
    """The 24-satellite shell of tests/test_receiver_e2e.py
    (`sim.constellation.gps_shell`), as one package's Ephemeris records."""
    return [lnav.Ephemeris(**{f.name: getattr(e, f.name)
                              for f in dataclasses.fields(e)})
            for e in tcon.gps_shell(TOE, n)]


def _same(got, want):
    """Equal to RTOL, recursing into tuples, lists, dicts, dataclasses."""
    if dataclasses.is_dataclass(got):
        assert type(got).__name__ == type(want).__name__
        for f in dataclasses.fields(got):
            _same(getattr(got, f.name), getattr(want, f.name))
    elif isinstance(got, dict):
        assert got.keys() == want.keys()
        for k in got:
            _same(got[k], want[k])
    elif isinstance(got, (tuple, list)) and not hasattr(got, "_fields"):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif hasattr(got, "_fields"):                   # NamedTuple
        for f in got._fields:
            _same(getattr(got, f), getattr(want, f))
    elif got is None or isinstance(got, (str, bool)):
        assert got == want
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), rtol=RTOL,
                                   atol=0)


def test_gps_shell_is_the_jax_tests_shell():
    from tests.test_receiver_e2e import TOE as e2e_toe, _shell as e2e_shell
    _same(_shell(jlnav), e2e_shell())
    assert e2e_toe == TOE


@pytest.mark.parametrize("cycle", [(1, 2, 3), (1, 2, 3, 4, 5)])
def test_lnav_round_trip_equals_jax(cycle):
    teph_, jeph_ = _shell(tlnav)[4], _shell(jlnav)[4]
    bits = tlnav.encode_frames(teph_, TOE + 12.0, 10, cycle=cycle)
    np.testing.assert_array_equal(
        bits, jlnav.encode_frames(jeph_, TOE + 12.0, 10, cycle=cycle))
    got, anchors = tlnav.decode_stream(1 - bits, prn=5)   # inverted
    want, janchors = jlnav.decode_stream(1 - bits, prn=5)
    _same(got, want)
    _same(anchors, janchors)
    assert got.complete and got.iode == teph_.iode
    assert abs(got.sqrt_a - teph_.sqrt_a) < 1e-3


def test_sat_pos_clock_equals_jax():
    tb = teph.stack_ephemeris(_shell(tlnav))
    jb = jeph.stack_ephemeris(_shell(jlnav))
    _same(tb, jb)
    for t in (TOE - 3600.0, TOE, TOE + 1234.5):
        t_sv = np.full(24, t) + np.arange(24) * 0.01
        _same(teph.sat_pos_clock(tb, t_sv), jeph.sat_pos_clock(jb, t_sv))
        _same(teph.sat_velocity(tb, t_sv), jeph.sat_velocity(jb, t_sv))


def _prompts(lnav, prn, n_epochs, seed, phase=7):
    """Synthetic tracking outputs of one channel: LNAV bits at 20 epochs
    each from `phase`, +/-1 prompts with noise, and the code-phase carry
    of a 2.048 MS/s window at a small code Doppler."""
    rng = np.random.default_rng(seed)
    eph = _shell(lnav)[prn - 1]
    bits = lnav.encode_frames(eph, TOE - 6.0, n_epochs // 6000 + 3)
    sym = 1.0 - 2.0 * bits[(np.arange(n_epochs) - phase) // 20 + 1]
    ip = 900.0 * sym + rng.normal(0, 60.0, n_epochs)
    fcode = 1.023e6 * (1.0 + 1500.0 / 1575.42e6)
    rem = (np.arange(n_epochs) * 2048 * fcode / FS + 100.0 + prn) % 1023.0
    cf = 1500.0 + rng.normal(0, 0.5, n_epochs)
    cn0 = 45.0 + rng.normal(0, 0.3, n_epochs)
    return [a.astype(np.float32) for a in (ip, rem, cf, cn0)]


def test_observables_equal_jax():
    n_ep = 20_000
    tch, jch = [], []
    for prn in (3, 8, 13, 19):
        ip, rem, cf, cn0 = _prompts(tlnav, prn, n_ep, seed=prn)
        kw = dict(prn=prn, i_prompt=ip, code_rem=rem, carr_freq=cf, cn0=cn0,
                  skip_epochs=600, sample_offset=float(prn * 10),
                  epoch_samples=2048)
        t = tobs.build_channel_observables(**kw)
        j = jobs.build_channel_observables(**kw)
        assert t is not None and j is not None
        _same(t, j)
        tch.append(t)
        jch.append(j)
    for m in (800, 5000, 19_000):
        _same(tobs.form_pseudoranges(tch, m), jobs.form_pseudoranges(jch, m))
    _same(tobs.accumulate_chips(rem), jobs.accumulate_chips(rem))
    _same(tobs.bit_sync(ip, 600), jobs.bit_sync(ip, 600))


def _geometry(pvt):
    rx = pvt.lla_to_ecef(*RX_LLA)
    rng = np.random.default_rng(3)
    sats = []
    for az, el in zip(rng.uniform(0, 360, 7), rng.uniform(15, 85, 7)):
        e, n = np.cos(np.radians(el)) * np.sin(np.radians(az)), \
            np.cos(np.radians(el)) * np.cos(np.radians(az))
        u = np.sin(np.radians(el))
        lat, lon = np.radians(RX_LLA[0]), np.radians(RX_LLA[1])
        enu2ecef = np.array([
            [-np.sin(lon), -np.sin(lat) * np.cos(lon),
             np.cos(lat) * np.cos(lon)],
            [np.cos(lon), -np.sin(lat) * np.sin(lon),
             np.cos(lat) * np.sin(lon)],
            [0.0, np.cos(lat), np.sin(lat)]])
        sats.append(rx + 2.2e7 * enu2ecef @ np.array([e, n, u]))
    sats = np.array(sats)
    rho = np.linalg.norm(sats - rx, axis=-1)
    pr = rho + 123.0 + rng.normal(0, 3.0, rho.shape)
    return sats, pr


def test_solve_wls_and_ekf_equal_jax():
    sats, pr = _geometry(tpvt)
    clk = np.arange(7) * 1e-6
    mask = np.array([True] * 6 + [False])
    t = tpvt.solve_wls(sats, pr, clk, mask=mask)
    j = jpvt.solve_wls(sats, pr, clk, mask=mask)
    assert t.valid
    _same(t, j)
    _same(tpvt.precheck_mask(np.full(7, 40.0), np.full(7, 2400),
                             np.full(7, TOE), pr, [True] * 7),
          jpvt.precheck_mask(np.full(7, 40.0), np.full(7, 2400),
                             np.full(7, TOE), pr, [True] * 7))
    te, je = tpvt.PvtEkf(), jpvt.PvtEkf()
    te.initialize(t)
    je.initialize(j)
    rng = np.random.default_rng(4)
    for _ in range(10):
        noisy = pr + rng.normal(0, 2.0, pr.shape)
        _same(te.step(sats, noisy, clk, dt_s=0.2),
              je.step(sats, noisy, clk, dt_s=0.2))
    _same(te.x, je.x)
    _same(te.P, je.P)
    _same(tpvt.ecef_to_lla(t.pos_ecef), jpvt.ecef_to_lla(j.pos_ecef))


def test_simulate_constellation_equals_jax():
    """A 0.1 s capture of the 24-satellite shell: samples, truths and the
    receiver position."""
    n = int(0.1 * FS)
    got = tcon.simulate_constellation(_shell(tlnav), RX_LLA, TOE + 30.0, n,
                                      FS, noise_std=0.3, seed=1)
    want = jcon.simulate_constellation(_shell(jlnav), RX_LLA, TOE + 30.0, n,
                                       FS, noise_std=0.3, seed=1)
    assert got[0].dtype == np.complex128 and got[0].shape == (n,)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL,
                               atol=RTOL * np.abs(want[0]).max())
    assert len(got[1]) >= 4
    _same([dataclasses.asdict(t) for t in got[1]],
          [dataclasses.asdict(t) for t in want[1]])
    _same(got[2], want[2])
