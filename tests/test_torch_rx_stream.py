"""The port's streaming receiver (runtime/rx_stream.py) vs the JAX package,
on the CPU.

- Health resets: the five mocked cases of tests/test_rx_health.py
  (nodecode, obs_stale, week, elevation, healthy) and its obs-horizon
  regression drive both receivers with the same fake acquisition,
  refinement and decode at 1.024 MS/s, 2 slots and 0.25 s segments over
  seeded noise: the tracked spans are equal exactly (the decisions there
  are the host bookkeeping's; the tracker only fills the streams).
- A real run: a port-rendered GPS capture (sim.constellation, 1.024 MS/s,
  4.5 s, x12 into a uint8 .bin) with a seeded NumPy broadband jam from 1.5
  to 3.0 s (amplitude 400 before x12, clipped at the uint8 rails) through
  both `process_file`s with 4 slots and 0.5 s segments. The jam forces a
  C/N0 reset and a re-acquisition in both; the spans are equal as sets of
  (sat, start, end) (the slot order follows float32 peak ratios). On the
  clean epochs after the pull-in (before the jam from 1 s into an
  interval, after it from 0.5 s) carr_freq agrees within 0.15 Hz,
  code_rem within 1e-2 chips, C/N0 within 0.1 dB and prompt-I signs
  exactly; cn0_epochs outside the jam within 0.1 dB. (C8: the jitted JAX
  tracker multiplies by constants' float32 reciprocals where the port
  divides exactly; test_torch_tracking states 0.1 Hz over 300 epochs, and
  1.5 s intervals carry it further: 0.103 Hz measured. Inside a jam 30 dB
  over the signal the loops are chaotic and only the decisions, the
  spans, are compared.)
- On the port, `process` of the same bytes equals `process_file` exactly;
  a run killed through `segment_cb` and resumed from its checkpoint equals
  the uninterrupted run bitwise; a checkpoint of another receiver raises
  ValueError; the acquisition start clamps into a short tail window as
  jax.lax.dynamic_slice clamps (C7), as the JAX package's does.
"""
import dataclasses
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_jamming_tpu.models.receiver import lnav as jlnav
from gps_jamming_tpu.ops import cplx
from gps_jamming_tpu.runtime import rx_stream as jrs
from gps_jamming_tpu_torch.models.receiver import lnav as tlnav
from gps_jamming_tpu_torch.ops import iq
from gps_jamming_tpu_torch.runtime import rx_stream as trs
from gps_jamming_tpu_torch.sim import constellation

torch.set_num_threads(2)

FS = 1.024e6                       # 1024-sample C/A period: cheap on CPU
RX_LLA = (50.06, 19.94, 219.0)
TOE = 345600.0
JAM_S = (1.5, 3.0)
TOTAL_S = 4.5


# --- mocked health resets ----------------------------------------------------

def _eph(mod, week=2400):
    return mod.Ephemeris(
        prn=5, week=week, toc=345600.0, af0=0.0, af1=0.0, af2=0.0,
        tgd=0.0, iodc=100, ura=1, health=0, iode=100, toe=345600.0,
        sqrt_a=np.sqrt(26_560_000.0), e=0.008, m0=2.0, delta_n=4.5e-9,
        omega0=1.0, omega_dot=-8.0e-9, omega=0.5, i0=0.958, idot=-3e-10,
        cuc=0.0, cus=0.0, crc=0.0, crs=0.0, cic=0.0, cis=0.0,
        have_subframes=(1, 2, 3))


class _FakeObs:
    """Stand-in for ChannelObservables: enough for the health probe and
    for _decode_pvt (1-epoch coverage keeps it out of every PVT epoch)."""

    def __init__(self, eph):
        self.eph = eph
        self.prn = eph.prn
        self.chips = np.zeros(1)
        self.cn0_dbhz = np.zeros(1)
        self.doppler_hz = np.zeros(1)


def _fake_acquire(xw, seg_start):
    out = np.zeros((5, 32), np.float32)
    out[0, 4] = 1.0                # PRN 5 acquired
    out[1, 4] = 100.0              # lag
    out[3, 4] = 5.0                # peak ratio
    out[4, 4] = 45.0               # cn0
    return out


# case -> (receiver kwargs, seconds of noise, build_obs(lnav module),
#          elevation or None, seed a probe fix)
CASES = {
    "nodecode": (dict(reset_nodecode_s=1.0), 2.0,
                 lambda mod: (lambda iv, n: None), None, False),
    "obs_stale": (dict(reset_obs_stale_s=1.0, reset_nodecode_s=1e9), 3.0,
                  lambda mod: (lambda iv, n, o=_FakeObs(_eph(mod)):
                               o if iv.start_epoch + n <= 1250 else None),
                  None, False),
    "week": (dict(reset_nodecode_s=1e9), 2.0,
             lambda mod: (lambda iv, n: _FakeObs(_eph(mod, week=100))),
             None, False),
    "elevation": (dict(reset_nodecode_s=1e9), 2.0,
                  lambda mod: (lambda iv, n: _FakeObs(_eph(mod))), 5.0,
                  True),
    "healthy": (dict(reset_nodecode_s=1.0, reset_obs_stale_s=1.0), 2.0,
                lambda mod: (lambda iv, n: _FakeObs(_eph(mod))), 45.0,
                False),
    "obs_horizon": (dict(reset_cn0_dbhz=1e9, grace_segments=7,
                         reset_obs_stale_s=0.25, reset_nodecode_s=1e9), 4.0,
                    lambda mod: (lambda iv, n, o=_FakeObs(_eph(mod)):
                                 o if iv.start_epoch == 0 else None),
                    None, False),
}


def _noise(seconds):
    rng = np.random.default_rng(1)
    n = int(seconds * FS)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64)


def _mocked(mod, lmod, case, **extra):
    kw, _, build, elev, seed_fix = CASES[case]
    kw = dict(kw)
    kw.setdefault("reset_cn0_dbhz", -1e9)
    kw.setdefault("min_cn0_dbhz", -1e9)
    rx = mod.StreamingReceiver(FS, system="gps", n_slots=2, segment_s=0.25,
                               health_probe_every_s=0.25, **kw, **extra)
    rx._acquire = _fake_acquire
    rx._refine = lambda xw, t2, lags, eff, c2, o2: np.asarray(eff)
    rx._build_obs = build(lmod)
    if elev is not None:
        rx._sat_elevation = lambda obs, local, fix: elev
    cb = None
    if seed_fix:
        def cb(done, n_total, snapshot):
            rx._probe_fix = np.array([3.7e6, 1.4e6, 5.0e6])
    return rx, cb


@pytest.mark.parametrize("case", list(CASES))
def test_health_reset_spans_match_jax(case):
    x = _noise(CASES[case][1])
    jrx, jcb = _mocked(jrs, jlnav, case)
    trx, tcb = _mocked(trs, tlnav, case, device="cpu")
    want = jrx.process(x, segment_cb=jcb)
    got = trx.process(x, segment_cb=tcb)
    assert got.tracked_spans == want.tracked_spans
    assert got.cn0_epochs.size == want.cn0_epochs.size
    spans, end = got.tracked_spans, got.cn0_epochs.size
    assert spans and spans[0][0] == 5
    if case == "healthy":
        assert spans == [(5, 0, end)]
    elif case == "obs_horizon":
        assert len(spans) == 2 and spans[1][2] == end
    else:
        assert spans[0][2] < end           # a reset mid-capture
    if case in ("nodecode", "obs_stale"):
        assert len(spans) >= 2             # and a re-acquisition
    assert trx.last_profile["n_acquire_calls"] == \
        jrx.last_profile["n_acquire_calls"]


# --- a real jammed capture ---------------------------------------------------

@pytest.fixture(scope="module")
def jammed_bin(tmp_path_factory):
    n = int(TOTAL_S * FS)
    x, truths, _ = constellation.simulate_constellation(
        constellation.gps_shell(TOE), RX_LLA, TOE - 1.3, n, FS,
        noise_std=0.4, seed=6)
    rng = np.random.default_rng(3)
    s0, s1 = int(JAM_S[0] * FS), int(JAM_S[1] * FS)
    x[s0:s1] += 400.0 * (rng.standard_normal(s1 - s0)
                         + 1j * rng.standard_normal(s1 - s0))
    path = str(tmp_path_factory.mktemp("rxs") / "jam.bin")
    iq.write_iq_file(path, x * 12.0)
    return path


def _port_rx(**kw):
    return trs.StreamingReceiver(FS, system="gps", n_slots=4,
                                 segment_s=0.5, device="cpu", **kw)


@pytest.fixture(scope="module")
def port_run(jammed_bin):
    rx = _port_rx()
    res = rx.process_file(jammed_bin, convention="centered")
    return rx, res


def _rem_diff(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.minimum(d, 1023.0 - d)


def test_jammed_capture_matches_jax(jammed_bin, port_run):
    trx, got = port_run
    jrx = jrs.StreamingReceiver(FS, system="gps", n_slots=4, segment_s=0.5)
    want = jrx.process_file(jammed_bin, convention="centered")
    end = got.cn0_epochs.size
    assert end == want.cn0_epochs.size == 4000
    assert set(got.tracked_spans) == set(want.tracked_spans)
    # the jam reset at least one channel, and a satellite came back
    assert any(b < end for _, _, b in got.tracked_spans)
    sats = [s for s, _, _ in got.tracked_spans]
    assert any(sats.count(s) > 1 for s in sats)
    j0, j1 = int(JAM_S[0] * 1000), int(JAM_S[1] * 1000)
    clean = np.r_[0:j0, j1:end]
    np.testing.assert_allclose(got.cn0_epochs[clean],
                               np.asarray(want.cn0_epochs)[clean], atol=0.1)
    assert np.isfinite(got.cn0_epochs).all()
    jiv = {(iv.sat_id, iv.start_epoch, iv.n_epochs): iv
           for iv in jrx.last_intervals}
    shared = 0
    for iv in trx.last_intervals:
        w = jiv.get((iv.sat_id, iv.start_epoch, iv.n_epochs))
        if w is None:
            continue
        shared += 1
        assert iv.sample_offset == w.sample_offset
        # clean epochs after the pull-in: before the jam from 1 s on, and
        # in the intervals acquired after it from 0.5 s on
        glob = iv.start_epoch + np.arange(iv.n_epochs)
        local = glob - iv.start_epoch
        m = ((glob < j0) & (local >= 1000)) | (
            (iv.start_epoch >= j1) & (local >= 500))
        if not m.any():
            continue
        assert np.abs(iv.carr_freq[m] - w.carr_freq[m]).max() <= 0.15
        assert _rem_diff(iv.code_rem[m], w.code_rem[m]).max() <= 1e-2
        assert np.abs(iv.cn0[m] - w.cn0[m]).max() <= 0.1
        assert np.all(np.sign(iv.i_prompt[m]) == np.sign(w.i_prompt[m]))
    assert shared == len(jrx.last_intervals)
    assert trx.last_profile["n_acquire_calls"] == \
        jrx.last_profile["n_acquire_calls"]
    assert set(trx.last_profile) == set(jrx.last_profile)


def test_process_equals_process_file(jammed_bin, port_run):
    rx_f, res_f = port_run
    rx = _port_rx()
    res = rx.process(iq.read_iq_file(jammed_bin, convention="centered"))
    assert res.tracked_spans == res_f.tracked_spans
    np.testing.assert_array_equal(res.cn0_epochs, res_f.cn0_epochs)
    for a, b in zip(rx.last_intervals, rx_f.last_intervals, strict=True):
        for f in ("i_prompt", "code_rem", "carr_freq", "cn0"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


class _Kill(Exception):
    pass


def test_killed_and_resumed_run_is_bitwise(jammed_bin, port_run, tmp_path):
    rx_a, res_a = port_run
    ck = str(tmp_path / "rx.ckpt")

    def kill(done, n_total, snapshot):
        if done == 5:
            raise _Kill()

    with pytest.raises(_Kill):
        _port_rx().process_file(jammed_bin, checkpoint_path=ck,
                                checkpoint_every_s=1.0, segment_cb=kill)
    with open(ck, "rb") as f:
        assert pickle.load(f)["next_seg"] == 4
    rx_c = _port_rx()
    res_c = rx_c.process_file(jammed_bin, checkpoint_path=ck,
                              checkpoint_every_s=1.0, resume=True)
    assert res_c.tracked_spans == res_a.tracked_spans
    np.testing.assert_array_equal(res_c.cn0_epochs, res_a.cn0_epochs)
    for a, c in zip(rx_a.last_intervals, rx_c.last_intervals, strict=True):
        assert dataclasses.astuple(a)[:5] == dataclasses.astuple(c)[:5]
        for f in ("i_prompt", "code_rem", "carr_freq", "cn0"):
            np.testing.assert_array_equal(getattr(a, f), getattr(c, f))
    assert [c.prn for c in res_c.channels] == [c.prn for c in res_a.channels]


def test_checkpoint_rejects_mismatched_receiver(tmp_path):
    rng = np.random.default_rng(0)
    path = str(tmp_path / "noise.bin")
    rng.integers(0, 256, int(2 * 0.6 * FS), dtype=np.uint8).tofile(path)
    ck = str(tmp_path / "rx.ckpt")
    with open(ck, "wb") as f:
        pickle.dump({"meta": {"fs": FS, "system": "gps",
                              "seg_epochs": 2000, "n_slots": 12,
                              "pvt_filter": "wls"}, "next_seg": 1}, f)
    rx = trs.StreamingReceiver(FS, system="gps", segment_s=0.25,
                               device="cpu")
    with pytest.raises(ValueError, match="checkpoint incompatible"):
        rx.process_file(path, checkpoint_path=ck, resume=True)


@pytest.mark.parametrize("seg_start", [0, 3000, 10_000_000])
def test_acquisition_start_clamps_like_jax(jammed_bin, seg_start):
    """A tail window shorter than seg_start + n_integration code periods:
    the start clamps to the last full block, as dynamic_slice clamps."""
    x = iq.read_iq_file(jammed_bin, convention="centered",
                        count=2 * 12_000)           # 11.7 code periods
    trx = trs.StreamingReceiver(FS, system="gps", n_slots=4, device="cpu")
    jrx = jrs.StreamingReceiver(FS, system="gps", n_slots=4)
    got = trx._acquire(torch.from_numpy(x), seg_start)
    tail = trx._acquire(torch.from_numpy(x[12_000 - 10 * 1024:]), 0)
    if seg_start >= 12_000 - 10 * 1024:
        np.testing.assert_array_equal(got, tail)
    want = np.asarray(jrx._acquire(cplx.CArray(
        jnp.asarray(x.real), jnp.asarray(x.imag)), seg_start))
    np.testing.assert_array_equal(got[0], want[0])          # acquired
    acq = want[0] > 0.5
    assert acq.sum() >= 3
    np.testing.assert_array_equal(got[1][acq], want[1][acq])  # lag
    np.testing.assert_allclose(got[2][acq], want[2][acq], atol=1e-3)
    np.testing.assert_allclose(got[3:], want[3:], rtol=1e-3, atol=1e-3)
