"""Port tracking (models/receiver/tracking.py) vs the JAX package.

The same seeded NumPy inputs go through the JAX functions and their torch
counterparts on the CPU: the per-epoch functions op by op (eager JAX, whose
arithmetic is the port's), the tracker's run jitted, as the JAX package
runs it. Tolerances, each with its reason:
- loop_coeffs: equal (the same Python float arithmetic);
- init_state: equal to 1 ulp (the same float32 operations);
- _mix_nco: 1e-5 absolute on unit-modulus phasors (cos/sin of another
  library, phases up to 1e4 rad at GLONASS's FDMA offsets);
- tap correlations: 1e-4 of the largest |I|, |Q| (float32 sums of n
  products in another order);
- discriminators: 1e-5 relative;
- the closed loop over ~300 epochs: carr_freq 0.1 Hz, code_rem 1e-2
  chips, prompt I and Q 5e-3 of the largest |I|, C/N0 0.1 dB. Jitted, XLA
  folds `code_freq / fs * n_epoch` into `code_freq * f32(n_epoch/fs)`,
  whose rounding puts the JAX package's code phase one float32 ulp
  (6.1e-5 chips at 1023) off the port's exact quotient on about half the
  epochs; sums in another order flip the last bit of the float32 code
  frequency (0.0625 Hz) now and then; the narrow DLL carries both for
  hundreds of epochs. Measured maxima: carr_freq 0.058 Hz, code_rem
  3.8e-3 chips, prompt 2.3e-3 of the largest |I|, C/N0 0.062 dB over 300
  epochs; equal prompt-I signs after pull-in.
Convergence against simulated truth (the JAX package's test_tracking.py
checks, on a NumPy-rendered signal) closes the file.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_jamming_tpu.config import TrackingConfig as JTrackingConfig
from gps_jamming_tpu.models.receiver import tracking as jtrk
from gps_jamming_tpu.ops import cplx
from gps_jamming_tpu_torch import convert
from gps_jamming_tpu_torch.config import TrackingConfig
from gps_jamming_tpu_torch.models.receiver import galileo, glonass
from gps_jamming_tpu_torch.models.receiver import tracking as ttrk
from gps_jamming_tpu_torch.ops import codes

torch.set_num_threads(2)

FS = 2.048e6
L1 = 1575.42e6


def _system(name):
    """(fs, n, code table (2, code_len), chip_rate, carriers, offsets)."""
    if name == "gps":
        table = np.stack([codes.gps_ca_code(p) for p in (7, 21)])
        return FS, 2048, table.astype(np.float32), 1.023e6, L1, (0.0, 0.0)
    if name == "galileo":
        table = np.stack([galileo.e1b_boc_code(p) for p in (11, 3)])
        return 4.096e6, 16384, table.astype(np.float32), galileo.BOC_RATE, \
            L1, (0.0, 0.0)
    offs = tuple(glonass.channel_offsets_hz(channels=[-3, 4]))
    carr = tuple(codes.glonass_carrier_hz(k) for k in (-3, 4))
    table = np.tile(codes.glonass_code()[None, :], (2, 1)).astype(np.float32)
    return 10e6, 10000, table, 0.511e6, carr, offs


def _states(name, seed):
    """The same random carry as a JAX TrackState and a port TrackState."""
    fs, n, table, chip, carr, offs = _system(name)
    rng = np.random.default_rng(seed)
    code_len = table.shape[1]
    dopp = rng.uniform(-4000.0, 4000.0, 2)
    carr_v = np.broadcast_to(np.asarray(carr, np.float64), (2,))
    f = dict(
        carr_freq_hz=dopp + np.asarray(offs),
        carr_phase_rad=rng.uniform(0, 2 * np.pi, 2),
        code_freq_hz=chip * (1.0 + dopp / carr_v),
        code_nco_hz=rng.normal(0.0, 0.2, 2),
        code_rem_chips=rng.uniform(0.0, code_len, 2),
        perr_prev=rng.normal(0, 0.1, 2), derr_prev=rng.normal(0, 0.05, 2),
        ip_prev=rng.normal(0, 50, 2), qp_prev=rng.normal(0, 50, 2),
        noise_ema=rng.uniform(1, 2, 2), sig_ema=rng.uniform(100, 200, 2))
    f = {k: v.astype(np.float32) for k, v in f.items()}
    js = jtrk.TrackState(**{k: jnp.asarray(v) for k, v in f.items()})
    return js, convert.track_state_from_jax(js, "cpu")


def _cx(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _jc(x):
    return cplx.CArray(jnp.asarray(x.real.copy()), jnp.asarray(x.imag.copy()))


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got.astype(np.float64) - want)))
    assert err <= tol, (err, tol)
    return err


def _rem_diff(got, want):
    """|got - want| of code phases [chips], across the 1023-chip wrap."""
    d = np.abs(got.numpy().astype(np.float64) - np.asarray(want))
    return np.minimum(d, 1023.0 - d)


def test_loop_coeffs_equal():
    for bw, damp, dt in ((30.0, 0.707, 1e-3), (2.0, 0.707, 4e-3),
                         (200.0, 0.5, 1e-3)):
        assert ttrk.loop_coeffs(bw, damp, dt) == jtrk.loop_coeffs(bw, damp,
                                                                  dt)


@pytest.mark.parametrize("name", ["gps", "galileo", "glonass"])
def test_init_state_matches_jax(name):
    fs, n, table, chip, carr, offs = _system(name)
    code_len = table.shape[1]
    dopp = np.array([1234.5, -3210.25], np.float32)
    lag = np.array([17.0, n - 3.0], np.float32)
    kw = dict(code_len=code_len, chip_rate=chip, carrier_hz=carr,
              nominal_offset_hz=offs)
    want = jtrk.init_state(2, dopp, lag, fs, **{
        k: (np.asarray(v, np.float32) if isinstance(v, tuple) else v)
        for k, v in kw.items()})
    got = ttrk.init_state(2, dopp, lag, fs, device="cpu", **kw)
    for f in ttrk.TrackState._fields:
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=1.2e-7, atol=0, err_msg=f)


@pytest.mark.parametrize("name", ["gps", "galileo", "glonass"])
def test_mix_nco_matches_jax(name):
    fs, n = _system(name)[:2]
    js, ts = _states(name, seed=1)
    x = _cx(n, seed=2)
    want = jtrk._mix_nco(_jc(x), js, fs, n)
    got = ttrk._mix_nco(torch.from_numpy(x), ts, fs, n)
    assert got.shape == (2, n) and got.dtype == torch.complex64
    _close(got.real, want.re, 1e-5 * 4)
    _close(got.imag, want.im, 1e-5 * 4)


@pytest.mark.parametrize("name", ["gps", "galileo", "glonass"])
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("form", ["exact", "base"])
def test_tap_correlate_matches_jax(name, per_channel, form):
    """GPS (2048 at 2.048 MS/s), Galileo E1B (16384 BOC at 4.096 MS/s) and
    GLONASS (10000 at 10 MS/s, each channel at its own FDMA offset), with
    one shared window or per-channel windows."""
    fs, n, table, chip, carr, offs = _system(name)
    js, ts = _states(name, seed=3)
    x = _cx((2, n) if per_channel else n, seed=4)
    cfg = TrackingConfig()
    if form == "exact":
        want = jtrk._tap_correlate(_jc(x), jnp.asarray(table), js, cfg.n_taps,
                                   cfg.tap_spacing_samples, fs,
                                   table.shape[1])
        got = ttrk._tap_correlate(torch.from_numpy(x),
                                  torch.from_numpy(table), ts, cfg.n_taps,
                                  cfg.tap_spacing_samples, fs, table.shape[1])
    else:
        margin = cfg.n_taps * cfg.tap_spacing_samples
        base = ttrk.resample_base_table(table, chip / fs, n, margin)
        np.testing.assert_array_equal(
            base, jtrk.resample_base_table(table, chip / fs, n, margin))
        want = jtrk._tap_correlate_base(_jc(x), jnp.asarray(base), js,
                                        cfg.n_taps, cfg.tap_spacing_samples,
                                        fs, chip, n)
        got = ttrk._tap_correlate_base(torch.from_numpy(x),
                                       torch.from_numpy(base), ts, cfg.n_taps,
                                       cfg.tap_spacing_samples, fs, chip, n)
    scale = max(float(np.max(np.abs(want[0]))), float(np.max(np.abs(want[1]))))
    assert got[0].shape == (2, 2 * cfg.n_taps + 1)
    _close(got[0], want[0], 1e-4 * scale)
    _close(got[1], want[1], 1e-4 * scale)


def test_resample_base_table_torch_matches_jnp():
    table = np.stack([codes.gps_ca_code(p) for p in (1, 2, 3)]).astype(
        np.float32)
    want = np.asarray(jtrk.resample_base_table_jnp(jnp.asarray(table),
                                                   1.023e6 / FS, 2048, 4))
    got = ttrk.resample_base_table_torch(torch.from_numpy(table),
                                         1.023e6 / FS, 2048, 4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_discriminators_match_jax():
    rng = np.random.default_rng(5)
    ci = rng.normal(0, 100, (3, 9)).astype(np.float32)
    cq = rng.normal(0, 100, (3, 9)).astype(np.float32)
    ci[0, 4] = 0.0                               # sign(0) and atan2(0, 0)
    js, ts = _states("gps", seed=6)
    js = js._replace(**{f: jnp.concatenate([getattr(js, f),
                                            getattr(js, f)[:1]])
                        for f in js._fields})
    ts = convert.track_state_from_jax(js, "cpu")
    want = jtrk._discriminators(jnp.asarray(ci), jnp.asarray(cq), js, 4,
                                1e-3)
    got = ttrk._discriminators(torch.from_numpy(ci), torch.from_numpy(cq),
                               ts, 4, 1e-3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def _two_sats(n_ms, lags, dopps, prns=(7, 21), noise_std=0.5, seed=7,
              fs=FS, n_epoch=2048):
    """NumPy-rendered GPS capture: each PRN's code starts at sample
    lags[k], at Doppler dopps[k] (carrier-aided code rate), unit amplitude,
    plus complex noise of noise_std per component."""
    n = n_ms * n_epoch
    i = np.arange(n, dtype=np.float64)
    rng = np.random.default_rng(seed)
    x = noise_std * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for prn, lag, d in zip(prns, lags, dopps):
        fcode = 1.023e6 * (1.0 + d / L1)
        chip = np.floor((i - lag) * fcode / fs).astype(np.int64) % 1023
        x = x + codes.gps_ca_code(prn)[chip] * np.exp(2j * np.pi * d * i / fs)
    return x.astype(np.complex64)


def _run_both(x, mode, lags, n_epochs=None):
    """The JAX and the port tracker over x, two channels, in one of the
    run modes; returns (jax outputs, port outputs, port final state)."""
    cfg, jcfg = TrackingConfig(), JTrackingConfig()
    table = np.stack([codes.gps_ca_code(p) for p in (7, 21)])
    dopp = np.array([2950.0, -1230.0], np.float32)      # handover errors
    lag0 = np.asarray(lags if mode == "plain" else (0, 0), np.float32)
    _, jrun, _ = jtrk.make_tracker(table, FS, jcfg)
    _, trun, n_epoch = ttrk.make_tracker(table, FS, cfg)
    jst = jtrk.init_state(2, dopp, lag0, FS)
    tst = ttrk.init_state(2, dopp, lag0, FS, device="cpu")
    kw_j, kw_t = {}, {}
    if mode in ("offsets", "start_epoch", "table_arg"):
        offs = np.asarray(lags, np.int32)
        kw_j["start_offsets"] = kw_t["start_offsets"] = offs
    if mode == "start_epoch":
        se = np.array([150, 790], np.int32)
        kw_j["start_epoch"] = jnp.asarray(se)
        kw_t["start_epoch"] = torch.from_numpy(se)
    if mode == "table_arg":
        # the build-time table is a placeholder; the overrides carry the
        # channels (the streaming receiver's slot reassignment)
        tab = np.stack([codes.gps_ca_code(p) for p in (7, 21)]).astype(
            np.float32)
        carr = np.full(2, L1, np.float32)
        offz = np.zeros(2, np.float32)
        placeholder = np.ones_like(tab)
        _, jrun, _ = jtrk.make_tracker(placeholder, FS, jcfg)
        _, trun, _ = ttrk.make_tracker(placeholder, FS, cfg)
        kw_j.update(table_arg=jnp.asarray(tab), carrier_arg=jnp.asarray(carr),
                    offset_arg=jnp.asarray(offz))
        kw_t.update(table_arg=torch.from_numpy(tab),
                    carrier_arg=torch.from_numpy(carr),
                    offset_arg=torch.from_numpy(offz))
    if n_epochs is not None:
        kw_j["n_epochs"] = kw_t["n_epochs"] = n_epochs
    _, jout = jax.jit(lambda s, d: jrun(s, d, **kw_j))(jst, _jc(x))
    tfin, tout = trun(tst, torch.from_numpy(x), **kw_t)
    return jout, tout, tfin


@pytest.mark.parametrize("mode", ["plain", "offsets", "start_epoch",
                                  "table_arg"])
def test_run_matches_jax(mode):
    """~300 epochs of 2 channels: the shared-window run; per-channel
    start_offsets (the K-epoch chunked gather, K = 15 here); per-channel
    start_epoch crossing the FLL and locked switches; and the table,
    carrier and offset overrides."""
    x = _two_sats(302, lags=(300, 1111), dopps=(3000.0, -1234.0))
    jout, tout, _ = _run_both(x, mode, (300, 1111))
    n_ep = 302 if mode == "plain" else (302 * 2048 - 1111) // 2048
    assert tout.i_prompt.shape == (n_ep, 2)
    assert np.asarray(jout.i_prompt).shape == (n_ep, 2)
    _close(tout.carr_freq_hz, jout.carr_freq_hz, 0.1)
    assert float(_rem_diff(tout.code_rem_chips,
                           jout.code_rem_chips).max()) <= 1e-2
    _close(tout.cn0_dbhz, jout.cn0_dbhz, 0.1)
    ip = np.asarray(jout.i_prompt)
    _close(tout.i_prompt, ip, 5e-3 * np.max(np.abs(ip)))
    _close(tout.q_prompt, jout.q_prompt, 5e-3 * np.max(np.abs(ip)))


def test_run_reproduces_the_dynamic_slice_clamp():
    """Asking for 40 epochs where 39 fit past the largest offset (1111)
    clamps the start of the last K = 10 chunk of channel 2 to
    len(x) - 10*2048, as jax.lax.dynamic_slice does; without the clamp the
    gather would index past the capture. Held to the first clamped epoch
    (30): after it channel 2 sees a code-phase jump and its loops run
    wild in both packages."""
    x = _two_sats(40, lags=(300, 1111), dopps=(3000.0, -1234.0))
    jout, tout, _ = _run_both(x, "offsets", (300, 1111), n_epochs=40)
    assert tout.i_prompt.shape == (40, 2)
    _close(tout.carr_freq_hz[:31], np.asarray(jout.carr_freq_hz)[:31], 0.1)
    ip = np.asarray(jout.i_prompt)[:31]
    _close(tout.i_prompt[:31], ip, 5e-3 * np.max(np.abs(ip)))


def test_step_matches_run():
    """`step` over the run's windows gives the run's outputs."""
    cfg = TrackingConfig()
    table = np.stack([codes.gps_ca_code(7)])
    x = torch.from_numpy(_two_sats(20, lags=(0,), dopps=(500.0,),
                                   prns=(7,)))
    step, run, n_epoch = ttrk.make_tracker(table, FS, cfg)
    st = ttrk.init_state(1, [480.0], [0.0], FS, device="cpu")
    _, outs = run(st, x)
    for e in range(20):
        st, o = step(st, (x[e * n_epoch:(e + 1) * n_epoch], e))
        assert torch.equal(o.i_prompt, outs.i_prompt[e])
        assert torch.equal(o.code_rem_chips, outs.code_rem_chips[e])


def test_track_state_from_jax():
    js, ts = _states("glonass", seed=8)
    for f in ttrk.TrackState._fields:
        assert getattr(ts, f).dtype == torch.float32
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))


# -- convergence against simulated truth (test_tracking.py's checks) -------

def _scene(sats, n_ms, noise_std, seed):
    """NumPy counterpart of sim.gps.scene: (prn, doppler, code phase
    [chips], nav bits) per satellite, unit amplitude."""
    n = n_ms * 2048
    t = np.arange(n, dtype=np.float64) / FS
    rng = np.random.default_rng(seed)
    x = noise_std * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for prn, dopp, cp, bits in sats:
        fcode = 1.023e6 * (1.0 + dopp / L1)
        chips_el = cp + t * fcode
        sig = codes.gps_ca_code(prn)[np.floor(chips_el).astype(np.int64)
                                     % 1023]
        if bits:
            bi = np.clip(np.floor(chips_el / (20 * 1023)).astype(np.int64),
                         0, len(bits) - 1)
            sig = sig * np.asarray(bits, np.float64)[bi]
        x = x + sig * np.exp(2j * np.pi * dopp * t)
    return torch.from_numpy(x.astype(np.complex64))


def _track(sats, n_ms, dopp_init, lags, noise_std=0.0, seed=0):
    table = np.stack([codes.gps_ca_code(s[0]) for s in sats])
    _, run, n_epoch = ttrk.make_tracker(table, FS, TrackingConfig())
    assert n_epoch == 2048
    st = ttrk.init_state(len(sats), np.asarray(dopp_init, np.float32),
                         np.asarray(lags, np.float32), FS,
                         device="cpu")
    return run(st, _scene(sats, n_ms, noise_std, seed))


def test_tracking_converges_to_truth():
    """Doppler within 5 Hz and code phase within 0.1 chip of the truth
    after 1000 epochs, from a 50 Hz handover error."""
    true_dopp = 1834.0
    final, _ = _track([(7, true_dopp, 0.0, ())], 1000, [true_dopp - 50.0],
                      [0.0])
    assert abs(float(final.carr_freq_hz[0]) - true_dopp) < 5.0
    fcode = 1.023e6 * (1.0 + true_dopp / L1)
    expect = (1000 * 2048 * fcode / FS) % 1023.0
    err = (float(final.code_rem_chips[0]) - expect + 511.5) % 1023.0 - 511.5
    assert abs(err) < 0.1


def test_tracking_prompt_power_and_cn0():
    """Prompt I dominates Q after lock; C/N0 in 60-70 dB-Hz (truth about
    66 dB-Hz at unit amplitude and noise 0.5)."""
    lag = (1023.0 - 512.25) / 1.023e6 * FS
    _, outs = _track([(3, -900.0, 512.25, ())], 600, [-850.0], [lag],
                     noise_std=0.5)
    ip = outs.i_prompt[-100:, 0].abs().mean()
    qp = outs.q_prompt[-100:, 0].abs().mean()
    assert float(ip) > 5.0 * float(qp)
    assert 60.0 < float(outs.cn0_dbhz[-1, 0]) < 70.0


def test_tracking_recovers_nav_bits():
    """The prompt-I signs reproduce the 20 ms nav bits (up to the Costas
    loop's polarity)."""
    rng = np.random.default_rng(5)
    bits = tuple((rng.integers(0, 2, 40) * 2 - 1).tolist())
    _, outs = _track([(21, 400.0, 0.0, bits)], 790, [400.0], [0.0],
                     noise_std=0.3)
    signs = torch.sign(outs.i_prompt[:, 0]).numpy()
    got = np.array([signs[b * 20 + 10] for b in range(30, 39)])
    want = np.array(bits[30:39], dtype=float)
    pol = np.sign(np.sum(got * want))
    assert np.all(got * pol == want)


def test_tracking_multichannel_batched():
    """Two channels track independently in one batched run."""
    final, _ = _track([(2, 2500.0, 0.0, ()), (9, -3100.0, 0.0, ())], 900,
                      [2450.0, -3150.0], [0.0, 0.0], noise_std=0.2)
    assert abs(float(final.carr_freq_hz[0]) - 2500.0) < 5.0
    assert abs(float(final.carr_freq_hz[1]) + 3100.0) < 5.0
