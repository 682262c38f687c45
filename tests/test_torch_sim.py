"""The port's simulator (sim/jammers, mix, trajectory, gps, glo, scenario)
vs the JAX package's, on the same inputs.

The deterministic parts are held to the JAX package's float32 arithmetic:
the time ramp t = arange(n)/fs equal bit for bit (also past 2^24
samples), the gates, rolls, envelopes, profiles, the clip and the code
and bit indices exactly; cos and sin of the same float32 phases differ by
at most one ulp between XLA's and torch's libraries (measured 5.96e-8 at
unit amplitude over 2^24 samples), so the waveforms are held to atol
2.4e-7 times their amplitude (4 ulp at 1.0). Written captures are held
byte for byte within 1 LSB: a waveform an ulp apart truncates to the next
integer only where it sits on one; the share of bytes that differ is
asserted under 1e-3 (measured 0 on these inputs).

jax.random's streams are not reproduced: the port draws from seeded
torch.Generators. The noisy parts are held by their moments (per
component variance within 3 %, mean within 4 sigma of zero, I-Q and
antenna-to-antenna correlation under 0.02) and by what the analysis
concludes on both packages' renders of one scenario: the same power
ranges within one 16 ms chunk, the same events, and an RSSI fix within
2 m of the jammer (the verify skill's bound) for both.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_jamming_tpu.ops import iq as jiq
from gps_jamming_tpu.sim import glo as jglo
from gps_jamming_tpu.sim import gps as jgps
from gps_jamming_tpu.sim import jammers as jjam
from gps_jamming_tpu.sim import mix as jmix
from gps_jamming_tpu.sim import scenario as jscn
from gps_jamming_tpu.sim import trajectory as jtraj
from gps_jamming_tpu_torch.ops import codes as tcodes
from gps_jamming_tpu_torch.sim import glo as tglo
from gps_jamming_tpu_torch.sim import gps as tgps
from gps_jamming_tpu_torch.sim import jammers as tjam
from gps_jamming_tpu_torch.sim import mix as tmix
from gps_jamming_tpu_torch.sim import scenario as tscn
from gps_jamming_tpu_torch.sim import trajectory as ttraj

torch.set_num_threads(2)

FS = 2.048e6
CPU = "cpu"
TRIG_ATOL = 2.4e-7
LLA = (50.06, 19.94, 219.0)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, amp=1.0):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=TRIG_ATOL * amp)


# --- jammers ---------------------------------------------------------------

def test_time_ramp_past_2_24_equals_jax():
    n = (1 << 24) + 4096
    want = np.asarray(jnp.arange(n, dtype=jnp.float32) / FS)
    got = tcodes.sample_times(n, FS, CPU).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        torch.arange(n, dtype=torch.float32).numpy(),
        np.asarray(jnp.arange(n, dtype=jnp.float32)))


@pytest.mark.parametrize("kw", [{}, {"offset_hz": -250e3, "amplitude": 3.0}])
def test_cw_matches_jax(kw):
    n = (1 << 17) + 5
    _close(tjam.cw(n, FS, device=CPU, **kw), jjam.cw(n, FS, **kw),
           kw.get("amplitude", 1.0))


@pytest.mark.parametrize("kw", [{}, {"f_start_hz": -400e3,
                                     "f_stop_hz": 400e3,
                                     "sweep_period_s": 0.01}])
def test_chirp_matches_jax(kw):
    n = 1 << 17                        # 64 ms: several 10 ms sweeps
    _close(tjam.chirp(n, FS, device=CPU, **kw), jjam.chirp(n, FS, **kw))


@pytest.mark.parametrize("kw", [{}, {"prf_hz": 3000.0, "duty": 0.2,
                                     "offset_hz": 50e3}])
def test_pulsed_matches_jax(kw):
    n = 1 << 17
    got = tjam.pulsed(n, FS, device=CPU, **kw)
    _close(got, jjam.pulsed(n, FS, **kw))
    duty = kw.get("duty", 0.5)
    assert abs(float((got.abs() > 0.5).float().mean()) - duty) < 0.01


def _moments(x: np.ndarray, var: float):
    """Per-component variance within 3 %, mean within 4 sigma of 0, I-Q
    correlation under 0.02."""
    re, im = np.real(x).astype(np.float64), np.imag(x).astype(np.float64)
    n = x.size
    for c in (re, im):
        assert abs(c.var() / var - 1.0) < 0.03, c.var()
        assert abs(c.mean()) < 4.0 * np.sqrt(var / n)
    assert abs(np.corrcoef(re, im)[0, 1]) < 0.02


def test_broadband_moments_match_jax():
    n = 1 << 16
    g = tjam.make_generator(3, CPU)
    got = tjam.broadband(n, g, amplitude=2.0).numpy()
    want = np.asarray(jjam.broadband(n, jax.random.PRNGKey(3), 2.0))
    assert got.dtype == want.dtype == np.complex64
    _moments(got, 4.0)
    _moments(want, 4.0)
    p = np.abs(np.fft.fft(got)) ** 2           # white, as test_sim.py
    assert p.max() / p.mean() < 30
    again = tjam.broadband(n, tjam.make_generator(3, CPU), 2.0).numpy()
    np.testing.assert_array_equal(got, again)   # seeded


def test_generate_dispatch():
    n = 4096
    for kind in ("cw", "chirp", "pulsed"):
        _close(tjam.generate(kind, n, FS, device=CPU),
               jjam.generate(kind, n, FS))
    bb = tjam.generate("broadband", n, FS, device=CPU)
    np.testing.assert_array_equal(
        bb.numpy(), tjam.broadband(n, tjam.make_generator(0, CPU)).numpy())
    with pytest.raises(ValueError, match="unknown jammer"):
        tjam.generate("sweep", n, FS, device=CPU)


# --- mix -------------------------------------------------------------------

def _cplx(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
            * scale).astype(np.complex64)


def test_weaken_matches_jax():
    sig = _cplx(50000, 1, 40.0)
    want = np.asarray(jmix.weaken(jnp.asarray(sig), noise_std=0.0))
    got = tmix.weaken(torch.from_numpy(sig), noise_std=0.0).numpy()
    np.testing.assert_array_equal(got, want)
    flat = np.full(200000, 8.0 + 0.0j, np.complex64)
    noisy = tmix.weaken(torch.from_numpy(flat), 0.125, 6.25,
                        tjam.make_generator(0, CPU)).numpy()
    _moments(noisy - 1.0, 6.25 ** 2)
    jn = np.asarray(jmix.weaken(jnp.asarray(flat), 0.125, 6.25,
                                jax.random.PRNGKey(0)))
    _moments(jn - 1.0, 6.25 ** 2)


@pytest.mark.parametrize("d", [5.0, 9.99, 10.0, 15.0, 20.0, 25.0,
                               [0.0, 3.0, 12.5, 19.0, 21.0]])
def test_distance_power_scale_matches_jax(d):
    want = np.asarray(jmix.distance_power_scale(
        jnp.asarray(d, jnp.float32), 20.0))
    got = tmix.distance_power_scale(
        torch.as_tensor(d, dtype=torch.float32), 20.0).numpy()
    np.testing.assert_array_equal(got, want)
    if not isinstance(d, list):
        assert float(tmix.distance_power_scale(d, 20.0)) == float(want)


@pytest.mark.parametrize("delay,dur", [(0.004, 0.003), (0.3, 0.4),
                                       (0.00123456, 0.0101)])
def test_inject_static_matches_jax(delay, dur):
    """The float32 gate and the truncated roll, on a jammer that does not
    fit an integer sample delay."""
    n = int(FS * 0.02) if delay < 0.1 else int(FS * 1.0)
    gps = _cplx(n, 2, 3.0)
    jam = np.asarray(jjam.chirp(n, FS))
    want = np.asarray(jmix.inject_static(jnp.asarray(gps), jnp.asarray(jam),
                                         FS, delay, dur, 2.0))
    got = tmix.inject_static(torch.from_numpy(gps), torch.from_numpy(jam),
                             FS, delay, dur, 2.0).numpy()
    np.testing.assert_array_equal(got, want)


def test_inject_profile_and_trajectory_profile_match_jax():
    d = np.array([5.0, 15.0, 12.0, 30.0], np.float32)
    want = np.asarray(jmix.trajectory_power_profile(jnp.asarray(d), 7, 20.0))
    got = tmix.trajectory_power_profile(torch.from_numpy(d), 7, 20.0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (28,)
    gps, jam = _cplx(28, 3), _cplx(28, 4)
    np.testing.assert_array_equal(
        tmix.inject_profile(torch.from_numpy(gps), torch.from_numpy(jam),
                            got).numpy(),
        np.asarray(jmix.inject_profile(jnp.asarray(gps), jnp.asarray(jam),
                                       jnp.asarray(want))))


@pytest.mark.parametrize("start,ramp", [(-1.0, 0.5), (0.003, 0.004),
                                        (0.001, 0.0)])
def test_spoof_mix_matches_jax(start, ramp):
    n = int(FS * 0.01)
    a, b = _cplx(n, 5, 10.0), _cplx(n, 6, 10.0)
    want = np.asarray(jmix.spoof_mix(jnp.asarray(a), jnp.asarray(b), FS,
                                     start, ramp, 4.0))
    got = tmix.spoof_mix(torch.from_numpy(a), torch.from_numpy(b), FS,
                         start, ramp, 4.0).numpy()
    np.testing.assert_array_equal(got, want)


def test_finalize_uint8_domain_matches_jax():
    x = _cplx(100000, 7, 90.0)
    want = np.asarray(jmix.finalize_uint8_domain(jnp.asarray(x)))
    got = tmix.finalize_uint8_domain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.real(got).max() == 127.0 and np.real(got).min() == -128.0
    zeros = torch.zeros(200000, dtype=torch.complex64)
    noisy = tmix.finalize_uint8_domain(zeros, 2.0).numpy()   # seed 1
    _moments(noisy, 4.0)


# --- trajectory (NumPy) ------------------------------------------------------

def test_trajectory_matches_jax(tmp_path):
    end = (50.0612, 19.9412, 240.0)
    want = jtraj.linear_trajectory(LLA, end, 3.3)
    got = ttraj.linear_trajectory(LLA, end, 3.3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        ttraj.jammer_distances(got, (50.0605, 19.9405, 230.0)),
        jtraj.jammer_distances(want, (50.0605, 19.9405, 230.0)))
    pa, pb = tmp_path / "a.csv", tmp_path / "b.csv"
    ttraj.write_user_motion_csv(str(pa), got)
    jtraj.write_user_motion_csv(str(pb), want)
    assert pa.read_text() == pb.read_text()


# --- gps, glo ----------------------------------------------------------------

GPS_SATS = [
    dict(prn=5, doppler_hz=1000.0, code_phase_chips=200.0),
    dict(prn=17, doppler_hz=-3210.5, code_phase_chips=12.75,
         carrier_phase_rad=0.7, amplitude=2.5,
         nav_bits=(1, -1, -1, 1, 1, -1), bit_periods=20),
    dict(prn=129, doppler_hz=250.0, code_phase_chips=317.25,
         nav_bits=(1, -1, 1, 1, -1, -1, 1, -1), bit_periods=2),
]


@pytest.mark.parametrize("kw", GPS_SATS)
def test_ca_baseband_matches_jax(kw):
    n = 10 * 2048 + 3
    want = jgps.ca_baseband(jgps.SatelliteSignal(**kw), n, FS)
    got = tgps.ca_baseband(tgps.SatelliteSignal(**kw), n, FS, device=CPU)
    _close(got, want, kw.get("amplitude", 1.0))


def test_gps_scene_matches_jax():
    n = 4 * 2048
    js = [jgps.SatelliteSignal(**k) for k in GPS_SATS]
    ts = [tgps.SatelliteSignal(**k) for k in GPS_SATS]
    _close(tgps.scene(ts, n, FS, device=CPU), jgps.scene(js, n, FS), 5.0)
    noisy = tgps.scene([], 1 << 17, FS, noise_std=3.0, device=CPU).numpy()
    _moments(noisy, 9.0)


def test_gps_baseband_acquirable():
    """A rendered C/A signal is found by the port's acquisition at its
    code phase and Doppler (as tests/test_sim.py holds the JAX one)."""
    from gps_jamming_tpu_torch.config import DEFAULT_CONFIG as CFG
    from gps_jamming_tpu_torch.models.receiver import acquisition as acq
    n = 2048
    sat = tgps.SatelliteSignal(prn=5, doppler_hz=1000.0,
                               code_phase_chips=200.0)
    x = tgps.scene([sat], 10 * n, FS, noise_std=1.0, device=CPU)
    res = acq.acquire_all(x.reshape(10, n),
                          tcodes.gps_replica_table(FS, n, CPU), FS,
                          CFG.acquisition)
    assert bool(res.acquired[4])
    assert abs(float(res.doppler_hz[4]) - 1000.0) <= 200.0
    expect_lag = (1023 - 200.0) * FS / 1.023e6 % n
    lag = int(res.code_phase[4])
    assert min(abs(lag - expect_lag), n - abs(lag - expect_lag)) < 4


GLO_SIGS = [dict(freq_ch=-3, doppler_hz=1500.0, code_phase_chips=100.5),
            dict(freq_ch=2, doppler_hz=-700.0, code_phase_chips=3.0,
                 amplitude=1.7, symbols=(0, 1, 1, 0, 1))]


@pytest.mark.parametrize("kw", GLO_SIGS)
def test_glo_baseband_matches_jax(kw):
    fs = 10e6
    n = 5 * 10000 + 7
    want = jglo.baseband(jglo.GloSignal(**kw), n, fs)
    got = tglo.baseband(tglo.GloSignal(**kw), n, fs, device=CPU)
    _close(got, want, kw.get("amplitude", 1.0))


def test_glo_scene_matches_jax():
    fs = 10e6
    n = 20000
    js = [jglo.GloSignal(**k) for k in GLO_SIGS]
    ts = [tglo.GloSignal(**k) for k in GLO_SIGS]
    _close(tglo.scene(ts, n, fs, device=CPU), jglo.scene(js, n, fs), 3.0)
    _moments(tglo.scene([], 1 << 17, fs, noise_std=0.5, device=CPU).numpy(),
             0.25)


# --- scenario ----------------------------------------------------------------

def _scn(mod, **kw):
    return mod.JammerScenario(**kw)


def test_scenario_geometry_matches_jax():
    kw = dict(kind="chirp", position_m=(4.0, 3.0), seed=7)
    ants = [(0.0, 0.0), (3.0, 0.0), (0.0, 3.0)]
    np.testing.assert_array_equal(
        tscn.antenna_distances(_scn(tscn, **kw), ants),
        jscn.antenna_distances(_scn(jscn, **kw), ants))
    for d in (0.5, 3.0, 5.0, 8.0):
        assert tscn.jammer_amplitude_at(_scn(tscn, **kw), d) == \
            jscn.jammer_amplitude_at(_scn(jscn, **kw), d)


@pytest.mark.parametrize("kind", ["cw", "chirp", "pulsed"])
def test_render_antenna_capture_noise_free_matches_jax(kind):
    kw = dict(kind=kind, position_m=(4.0, 3.0), start_s=0.0031,
              duration_s=0.0102, seed=7)
    n = int(FS * 0.02)
    want = jscn.render_antenna_capture(_scn(jscn, **kw), (3.0, 0.0), n, FS,
                                       noise_std=0.0, antenna_index=1)
    got = tscn.render_antenna_capture(_scn(tscn, **kw), (3.0, 0.0), n, FS,
                                      noise_std=0.0, antenna_index=1,
                                      device=CPU)
    amp = tscn.jammer_amplitude_at(_scn(tscn, **kw), np.hypot(1.0, 3.0))
    _close(got, want, amp)


def _bytes_within_one_lsb(got_path, want_path):
    a = np.fromfile(got_path, np.uint8).astype(np.int16)
    b = np.fromfile(want_path, np.uint8).astype(np.int16)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1
    share = float(np.mean(a != b))
    print(f"{os.path.basename(got_path)}: share of bytes that differ "
          f"{share:.3g}")
    assert share < 1e-3, share
    return share


@pytest.mark.parametrize("kind", ["cw", "chirp", "pulsed"])
def test_write_capture_set_noise_free_bytes(tmp_path, kind):
    kw = dict(kind=kind, position_m=(4.0, 3.0), start_s=0.01,
              duration_s=0.02, seed=7)
    ants = [(0.0, 0.0), (3.0, 0.0), (0.0, 3.0)]
    n = 1 << 16
    tp = [str(tmp_path / f"t{i}.bin") for i in range(3)]
    jp = [str(tmp_path / f"j{i}.bin") for i in range(3)]
    tscn.write_capture_set(_scn(tscn, **kw), ants, tp, n, FS, noise_std=0.0,
                           device=CPU)
    jscn.write_capture_set(_scn(jscn, **kw), ants, jp, n, FS, noise_std=0.0)
    for a, b in zip(tp, jp):
        assert os.path.getsize(a) == 2 * n
        _bytes_within_one_lsb(a, b)


def test_moving_jammer_matches_jax(tmp_path):
    kw = dict(kind="cw", position_m=(6.0, 0.0), seed=3)
    n = int(FS * 0.3)
    want = jscn.moving_jammer_profile(_scn(jscn, **kw), (0.0, 0.0),
                                      (-6.0, 0.0), n, FS)
    got = tscn.moving_jammer_profile(_scn(tscn, **kw), (0.0, 0.0),
                                     (-6.0, 0.0), n, FS, device=CPU)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tp, jp = str(tmp_path / "t0.bin"), str(tmp_path / "j0.bin")
    tscn.write_moving_capture_set(_scn(tscn, **kw), [(0.0, 0.0)],
                                  (-6.0, 0.0), [tp], n, FS, noise_std=0.0,
                                  device=CPU)
    jscn.write_moving_capture_set(_scn(jscn, **kw), [(0.0, 0.0)],
                                  (-6.0, 0.0), [jp], n, FS, noise_std=0.0)
    _bytes_within_one_lsb(tp, jp)
    # noisy: the envelope peaks at closest approach (test_sim_modes.py)
    x = tscn.render_antenna_capture_moving(
        _scn(tscn, **kw), (0.0, 0.0), (-6.0, 0.0), n, FS, noise_std=0.5,
        device=CPU).numpy()
    chunk = 16384
    pc = (np.abs(x[: x.size // chunk * chunk]) ** 2
          ).reshape(-1, chunk).mean(axis=1)
    k = int(np.argmax(pc))
    assert 0.3 < k / pc.size < 0.7
    assert pc[k] > 4.0 * pc[0] and pc[k] > 4.0 * pc[-1]


def test_gps_shell_and_background_match_jax():
    ts, js = tscn.synthetic_gps_shell(), jscn.synthetic_gps_shell()
    assert [vars(a) for a in ts] == [vars(b) for b in js]
    n = 3 * 2048
    tow0 = tscn.DEFAULT_TOE_S - 1.3
    assert tscn.DEFAULT_TOE_S == jscn.DEFAULT_TOE_S
    tb, tt, tr = tscn.gps_background(LLA, tow0, n, FS)
    jb, jt, jr = jscn.gps_background(LLA, tow0, n, FS)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tr, jr)
    assert [t.prn for t in tt] == [t.prn for t in jt]
    end = (LLA[0] + 2e-4, LLA[1], LLA[2])
    tb, _, _ = tscn.gps_background(LLA, tow0, n, FS, end_lla=end)
    jb, _, _ = jscn.gps_background(LLA, tow0, n, FS, end_lla=end)
    np.testing.assert_array_equal(tb, jb)


def test_clean_capture_matches_jax(tmp_path):
    n = 4 * 2048
    tp, jp = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
    tscn.write_clean_capture(tp, LLA, n, FS, weaken_gps=False, seed=3,
                             device=CPU)
    jscn.write_clean_capture(jp, LLA, n, FS, weaken_gps=False, seed=3)
    _bytes_within_one_lsb(tp, jp)
    # weakened: x0.125 of the render plus AWGN of 6.25 per component
    wp = str(tmp_path / "w.bin")
    tscn.write_clean_capture(wp, LLA, 16 * 2048, FS, seed=3, device=CPU)
    bg, _, _ = tscn.gps_background(LLA, tscn.DEFAULT_TOE_S - 1.3, 16 * 2048,
                                   FS, seed=3)
    x = jiq.read_iq_file(wp, convention="centered")
    resid = x - np.clip(0.125 * bg, -128, 127)
    assert abs(np.real(resid).std() - 6.25) < 0.25


def test_clean_capture_acquirable(tmp_path):
    """Mode A weakened: at least 4 PRNs acquired (test_sim_modes.py)."""
    from gps_jamming_tpu_torch.config import DEFAULT_CONFIG as CFG
    from gps_jamming_tpu_torch.models.receiver import acquisition as acq
    path = str(tmp_path / "clean0.bin")
    tscn.write_clean_capture(path, LLA, 16 * 2048, FS, seed=3, device=CPU)
    x = torch.from_numpy(jiq.read_iq_file(path)[: 10 * 2048])
    res = acq.acquire_all(x.reshape(10, 2048),
                          tcodes.gps_replica_table(FS, 2048, CPU), FS,
                          CFG.acquisition)
    assert int(res.acquired.sum()) >= 4


def test_spoof_capture_matches_jax(tmp_path):
    n = 4 * 2048
    fake = (50.30, 20.20, 15000.0)
    tp, jp = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
    te = tscn.write_spoof_capture(tp, LLA, fake, n, FS, start_s=0.001,
                                  ramp_s=0.002, noise_std=0.0, seed=5,
                                  device=CPU)
    je = jscn.write_spoof_capture(jp, LLA, fake, n, FS, start_s=0.001,
                                  ramp_s=0.002, noise_std=0.0, seed=5)
    np.testing.assert_array_equal(te, je)
    _bytes_within_one_lsb(tp, jp)
    assert np.linalg.norm(te) > 6.3e6


def _analysis(paths, ants):
    from gps_jamming_tpu_torch.runtime import pipeline
    return pipeline.analyze_capture(paths, antenna_positions=ants,
                                    run_receiver=False, device=CPU)


def test_noisy_capture_set_gives_jax_conclusions(tmp_path):
    """Both packages' renders of one jammed scenario (noise 1 LSB, the
    jam from 0.1 s to EOF) lead the port's analysis to the same power
    ranges (within one chunk), events and an RSSI fix within 2 m of the
    jammer; the port's antennas' noise is independent."""
    kw = dict(kind="chirp", position_m=(4.0, 3.0), start_s=0.1,
              duration_s=10.0, seed=7)
    ants = [(0.0, 0.0), (3.0, 0.0), (0.0, 3.0)]
    n = int(FS * 0.4)
    tp = [str(tmp_path / f"t{i}.bin") for i in range(3)]
    jp = [str(tmp_path / f"j{i}.bin") for i in range(3)]
    tscn.write_capture_set(_scn(tscn, **kw), ants, tp, n, FS, noise_std=1.0,
                           device=CPU)
    jscn.write_capture_set(_scn(jscn, **kw), ants, jp, n, FS, noise_std=1.0)
    got, want = _analysis(tp, ants), _analysis(jp, ants)
    chunk_bytes = 2 * 32768
    assert len(got.power_ranges) == len(want.power_ranges) == 1
    for (a, b), (c, d) in zip(got.power_ranges, want.power_ranges):
        assert abs(a - c) <= chunk_bytes and abs(b - d) <= chunk_bytes
    assert len(got.events) == len(want.events) == 1
    assert abs(got.events[0]["start_time"] - 0.1) <= 0.016
    assert abs(got.events[0]["start_time"]
               - want.events[0]["start_time"]) <= 0.016
    for res in (got, want):
        x, y = res.localization["location_meters"]
        assert np.hypot(x - 4.0, y - 3.0) < 2.0, (x, y)
    # the noise before the jam, as written (1 LSB rms, truncated to the
    # uint8 grid): the JAX render's spread, independent across antennas
    pre = [jiq.read_iq_file(p)[: int(0.09 * FS)] for p in tp]
    pre_j = [jiq.read_iq_file(p)[: int(0.09 * FS)] for p in jp]
    for x, y in zip(pre, pre_j):
        for part in (np.real, np.imag):
            assert abs(part(x).std() / part(y).std() - 1.0) < 0.03
    for i in range(3):
        for k in range(i + 1, 3):
            assert abs(np.corrcoef(np.real(pre[i]), np.real(pre[k]))[0, 1]) \
                < 0.02


def test_broadband_capture_set_antennas_differ(tmp_path):
    kw = dict(kind="broadband", position_m=(4.0, 3.0), start_s=0.0,
              duration_s=1.0, seed=2)
    caps = [tscn.render_antenna_capture(_scn(tscn, **kw), p, 1 << 16, FS,
                                        noise_std=0.0, antenna_index=i,
                                        device=CPU).numpy()
            for i, p in enumerate([(0.0, 0.0), (3.0, 0.0)])]
    assert abs(np.corrcoef(np.real(caps[0]), np.real(caps[1]))[0, 1]) < 0.02
    again = tscn.render_antenna_capture(_scn(tscn, **kw), (0.0, 0.0),
                                        1 << 16, FS, noise_std=0.0,
                                        device=CPU).numpy()
    np.testing.assert_array_equal(caps[0], again)


def test_simulators_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tjam.cw(16, FS),
                 lambda: tgps.scene([], 16, FS),
                 lambda: tglo.scene([], 16, FS),
                 lambda: tscn.write_capture_set(
                     tscn.JammerScenario(), [(0.0, 0.0)],
                     [str(tmp_path / "x.bin")], 64)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
