"""The port's GPS receiver chain (models/receiver/receiver.py) vs the JAX
package's `run_receiver`, on the CPU.

The 0.12 s capture of tests/test_receiver_e2e.py::
test_receiver_chain_with_pcf_config (the 24-satellite shell at TOE + 30 s,
noise 0.3, seed 4) goes through both packages' `run_receiver` with the PCF
acquisition and 6 channels. Held: the same acquired set, code phases and
acquisition Dopplers (exact: the same grid), the fine-Doppler handover of
every selected channel within 0.05 Hz (float32 sums of 32 ms in another
order), and the per-epoch mean tracked C/N0 within 0.05 dB (the tracking
loops' tolerance, tests/test_torch_tracking.py). Too short for a decode:
no channel is decoded and no fix is formed, in either package. Galileo,
GLONASS and SBAS run the same comparison on short captures of their own.
"""
import numpy as np
import pytest
import torch

from gps_jamming_tpu.config import AcquisitionConfig as JAcquisitionConfig
from gps_jamming_tpu.models.receiver import acquisition as jacq
from gps_jamming_tpu.models.receiver import lnav as jlnav
from gps_jamming_tpu.models.receiver import receiver as jrx
from gps_jamming_tpu.ops import codes as jcodes
from gps_jamming_tpu.ops import cplx
from gps_jamming_tpu_torch.config import AcquisitionConfig
from gps_jamming_tpu_torch.models.receiver import acquisition as tacq
from gps_jamming_tpu_torch.models.receiver import receiver as trx
from gps_jamming_tpu_torch.ops import codes as tcodes
from gps_jamming_tpu_torch.sim import constellation as tcon

torch.set_num_threads(2)

FS = 2.048e6
RX_LLA = (50.06, 19.94, 219.0)
TOE = 345600.0


@pytest.fixture(scope="module")
def capture():
    iq, truths, _ = tcon.simulate_constellation(
        tcon.gps_shell(TOE), RX_LLA, TOE + 30.0, int(0.12 * FS), FS,
        noise_std=0.3, seed=4)
    return iq.astype(np.complex64), truths


@pytest.fixture(scope="module")
def both(capture):
    x, _ = capture
    cfg = AcquisitionConfig(method="pcf")
    jcfg = JAcquisitionConfig(method="pcf")
    return (trx.run_receiver(torch.from_numpy(x), FS, acq_cfg=cfg,
                             max_channels=6),
            jrx.run_receiver(x, FS, acq_cfg=jcfg, max_channels=6))


def test_receiver_acquires_as_jax(both, capture):
    got, want = both
    _, truths = capture
    assert [c.prn for c in got.channels] == list(range(1, 33))
    acq = [c.prn for c in got.channels if c.acquired]
    assert acq == [c.prn for c in want.channels if c.acquired]
    assert len(acq) >= 4 and set(acq) <= {t.prn for t in truths}
    for g, w in zip(got.channels, want.channels):
        if w.acquired:
            assert g.code_phase_samples == w.code_phase_samples
            assert g.doppler_hz == w.doppler_hz
            assert abs(g.peak_ratio - w.peak_ratio) <= 1e-3 * w.peak_ratio


def test_receiver_handover_and_tracking_match_jax(both, capture):
    got, want = both
    x, _ = capture
    sel = sorted((c for c in got.channels if c.acquired),
                 key=lambda c: -c.peak_ratio)[:6]
    table = np.stack([tcodes.gps_ca_code(c.prn) for c in sel])
    lags = np.array([c.code_phase_samples for c in sel], np.int32)
    dopp = np.array([c.doppler_hz for c in sel], np.float32)
    fine = tacq.refine_doppler(torch.from_numpy(x), table, lags, dopp, FS,
                               1.023e6).numpy()
    jfine = np.asarray(jacq.refine_doppler(
        cplx.from_complex(x), np.stack([jcodes.gps_ca_code(c.prn)
                                        for c in sel]), lags, dopp, FS,
        1.023e6))
    np.testing.assert_allclose(fine, jfine, rtol=0, atol=0.05)
    assert got.tracked_spans == want.tracked_spans
    assert got.cn0_epochs.shape == want.cn0_epochs.shape
    np.testing.assert_allclose(got.cn0_epochs, want.cn0_epochs, rtol=0,
                               atol=0.05)
    assert not got.fixes and not want.fixes
    assert set(got.stage_seconds) == {"acquire", "refine", "track",
                                      "decode", "pvt"}


def _other_system_capture(system):
    """(x, fs, acq_cfg pair, skip_epochs) of a 0.3 s JAX-rendered capture:
    the closed-loop tests' Galileo shell at 4.096 MS/s (std acquisition
    over 4 periods and +/-3.5 kHz, to keep the CPU's search small), their
    GLONASS shell at 4 MS/s, and the SBAS channel test's PRN 129 at 2.048
    MS/s with its three MT12 messages."""
    import jax
    from gps_jamming_tpu.models.receiver import sbas as jsbas
    from gps_jamming_tpu.sim import constellation as jcon
    from gps_jamming_tpu.sim import gps as jsim
    from tests.test_multiconstellation_e2e import _gal_shell, _glo_shell
    kw = {}
    if system == "galileo":
        fs = 4.096e6
        x, _, _ = jcon.simulate_galileo_constellation(
            _gal_shell(), RX_LLA, TOE + 30.0, int(0.3 * fs), fs,
            noise_std=0.3, seed=1)
        kw = dict(n_integration=4, doppler_max_hz=3500.0,
                  doppler_step_hz=250.0)
        skip = 20
    elif system == "glonass":
        fs = 4e6
        x, _, _ = jcon.simulate_glonass_constellation(
            _glo_shell(27030.0, 27000.0), RX_LLA, 27030.0, int(0.3 * fs),
            fs, noise_std=0.3, seed=3)
        skip = 100
    else:
        fs = FS
        sym = jsbas.encode_stream([
            jsbas.build_mt12(TOE + k, 310, preamble_idx=k % 3)
            for k in range(3)])
        sat = jsim.SatelliteSignal(
            prn=129, doppler_hz=1250.0, code_phase_chips=317.25,
            nav_bits=tuple((2 * sym - 1).tolist()), bit_periods=2)
        x = np.asarray(jsim.scene([sat], int(0.3 * fs), fs, noise_std=0.8,
                                  key=jax.random.PRNGKey(11)))
        skip = 100
    return (x.astype(np.complex64), fs,
            (AcquisitionConfig(**kw), JAcquisitionConfig(**kw)), skip)


@pytest.mark.parametrize("system", ["galileo", "glonass", "sbas"])
def test_other_systems_raise(system):
    """Galileo, GLONASS and SBAS run the chain as the JAX package's
    `run_receiver` does, on a 0.3 s capture with a skip_epochs that leaves
    the decoders most of it: the same ids, acquired set, code phases and
    acquisition Dopplers (exact), the same tracked spans, and the
    per-epoch mean C/N0 within 0.1 dB (the closed loop's spread,
    tests/test_torch_tracking.py). Too short for a decode: no channel
    decodes, no message, no fix, in either package (SBAS decodes its
    tracked channel, to an empty message list). Only a system the
    receiver does not know raises."""
    x, fs, (cfg, jcfg), skip = _other_system_capture(system)
    got = trx.run_receiver(torch.from_numpy(x), fs, acq_cfg=cfg,
                           system=system, skip_epochs=skip)
    want = jrx.run_receiver(x, fs, acq_cfg=jcfg, system=system,
                            skip_epochs=skip)
    assert [c.prn for c in got.channels] == [c.prn for c in want.channels]
    acq = [c.prn for c in got.channels if c.acquired]
    assert acq == [c.prn for c in want.channels if c.acquired]
    assert len(acq) >= (1 if system == "sbas" else 4)
    for g, w in zip(got.channels, want.channels):
        if w.acquired:
            assert g.code_phase_samples == w.code_phase_samples
            assert g.doppler_hz == w.doppler_hz
        assert g.obs is None and w.obs is None
        assert not g.messages and g.messages == w.messages
    assert got.tracked_spans == want.tracked_spans
    assert got.epoch_ms == want.epoch_ms
    np.testing.assert_allclose(got.cn0_epochs, want.cn0_epochs, rtol=0,
                               atol=0.1)
    assert not got.fixes and not want.fixes
    assert set(got.stage_seconds) == {"acquire", "refine", "track",
                                      "decode", "pvt"}
    with pytest.raises(ValueError, match="unknown system"):
        trx.run_receiver(torch.from_numpy(x[:40_960]), FS, system="beidou")


def test_ephemeris_classes_share_fields():
    """The port's lnav.Ephemeris has the JAX package's fields, so decoded
    records compare field by field."""
    import dataclasses
    from gps_jamming_tpu_torch.models.receiver import lnav
    assert [f.name for f in dataclasses.fields(lnav.Ephemeris)] == \
        [f.name for f in dataclasses.fields(jlnav.Ephemeris)]
