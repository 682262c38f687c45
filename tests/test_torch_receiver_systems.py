"""Port acquisition of the other systems vs the JAX package: Galileo E1B
(`acquisition.acquire_all` with the E1B replica, 'std' and 'auto') and
GLONASS (`glonass.acquire_all`, 'pcf' and 'std').

Decisions, code phases and Dopplers must be equal; peak ratio, C/N0 and
peak power within rtol 1e-4.

- Galileo: two E1B PRNs in 2 blocks of 16384 at 4.096 MS/s, rendered
  band-limited (a raw square-wave BOC aliases its 2.046 MHz subcarrier
  line into the Doppler band), as tests/test_galileo.py builds them; at 2
  blocks 'auto' resolves to std.
- GLONASS: two FDMA channels at 10 MS/s, 4 blocks of 10000, from the JAX
  simulator as the fixture generator, searched over four channels to keep
  the CPU's std intermediates small.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_jamming_tpu.config import AcquisitionConfig as JAcquisitionConfig
from gps_jamming_tpu.models.receiver import acquisition as jacq
from gps_jamming_tpu.models.receiver import galileo as jgal
from gps_jamming_tpu.models.receiver import glonass as jglo
from gps_jamming_tpu.ops import codes as jcodes
from gps_jamming_tpu.ops import cplx
from gps_jamming_tpu.sim import glo as sim_glo
from gps_jamming_tpu_torch import convert
from gps_jamming_tpu_torch.config import AcquisitionConfig
from gps_jamming_tpu_torch.models.receiver import acquisition as tacq
from gps_jamming_tpu_torch.models.receiver import galileo as tgal
from gps_jamming_tpu_torch.models.receiver import glonass as tglo

torch.set_num_threads(2)


def _assert_same_result(got, want):
    for f in ("acquired", "code_phase", "doppler_hz"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    for f in ("peak_ratio", "cn0_dbhz", "peak_power"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-4)


def _jax_blocks(x):
    return cplx.CArray(jnp.asarray(x.real.copy()), jnp.asarray(x.imag.copy()))


GAL_FS = 4.096e6
GAL_N = 16384                  # 4 ms
GAL_PRNS = range(1, 9)
GAL_CFG = AcquisitionConfig(doppler_step_hz=150.0, doppler_max_hz=4500.0)
J_GAL_CFG = JAcquisitionConfig(**dataclasses.asdict(GAL_CFG))


def _e1b_blocks():
    """PRN 4 (+900 Hz) and PRN 7 (-2100 Hz), band-limited, in numpy
    complex noise of 0.4 rms per component."""
    rng = np.random.default_rng(41)
    n = 2 * GAL_N
    t = np.arange(n) / GAL_FS
    x = 0.4 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for prn, dopp, cp in ((4, 900.0, 1000.5), (7, -2100.0, 7000.0)):
        f = jgal.BOC_RATE * (1.0 + dopp / 1575.42e6)
        chips = np.asarray(jcodes.resample_code_bandlimited(
            jnp.asarray(jgal.e1b_boc_code(prn), jnp.float32), f, GAL_FS, n,
            rem_chips=cp))
        x = x + chips * np.exp(2j * np.pi * dopp * t)
    return x.astype(np.complex64).reshape(2, GAL_N)


@pytest.mark.parametrize("method", ["std", "auto"])
def test_galileo_acquisition_matches_jax(method):
    x = _e1b_blocks()
    planes = tgal.replica_table_host(GAL_FS, GAL_N, prns=GAL_PRNS)
    kw = dict(code_period_s=tgal.PERIOD_S, code_len_chips=tgal.BOC_LEN,
              method=method)
    want = jacq.acquire_all(
        _jax_blocks(x),
        cplx.CArray(jnp.asarray(planes[0]), jnp.asarray(planes[1])), GAL_FS,
        J_GAL_CFG, **kw)
    got = tacq.acquire_all(torch.from_numpy(x),
                           convert.replica_from_jax(planes, "cpu"), GAL_FS,
                           GAL_CFG,
                           **kw)
    _assert_same_result(got, want)
    assert got.acquired.tolist() == [p in (4, 7) for p in GAL_PRNS]
    assert abs(float(got.doppler_hz[3]) - 900.0) <= 100.0
    assert abs(float(got.doppler_hz[6]) + 2100.0) <= 100.0


GLO_FS = 10e6
GLO_N = 10000                  # 1 ms
GLO_CHANNELS = (-3, 0, 4, 6)
GLO_CFG = AcquisitionConfig(doppler_step_hz=250.0)
J_GLO_CFG = JAcquisitionConfig(**dataclasses.asdict(GLO_CFG))


def _glo_blocks():
    sigs = [sim_glo.GloSignal(freq_ch=-3, doppler_hz=1500.0,
                              code_phase_chips=123.25),
            sim_glo.GloSignal(freq_ch=4, doppler_hz=-2800.0,
                              code_phase_chips=401.0, amplitude=0.9)]
    x = sim_glo.scene(sigs, 4 * GLO_N, GLO_FS, noise_std=0.4,
                      key=jax.random.PRNGKey(2))
    return np.asarray(x).astype(np.complex64).reshape(4, GLO_N)


@pytest.mark.parametrize("method", ["pcf", "std"])
def test_glonass_acquisition_matches_jax(method):
    x = _glo_blocks()
    want = jglo.acquire_all(_jax_blocks(x), GLO_FS, J_GLO_CFG,
                            channels=GLO_CHANNELS, method=method)
    got = tglo.acquire_all(torch.from_numpy(x), GLO_FS, GLO_CFG,
                           channels=GLO_CHANNELS, method=method)
    _assert_same_result(got, want)
    assert got.acquired.tolist() == [ch in (-3, 4) for ch in GLO_CHANNELS]


def test_glonass_nearfar_veto_matches_jax():
    """A channel at the lag of a 100x stronger acquired one is vetoed."""
    res = tacq.AcquisitionResult(
        acquired=torch.tensor([True, True, True, False]),
        code_phase=torch.tensor([10, 9995, 500, 12], dtype=torch.int32),
        doppler_hz=torch.zeros(4), peak_ratio=torch.full((4,), 5.0),
        cn0_dbhz=torch.zeros(4),
        peak_power=torch.tensor([1e6, 5e3, 5e3, 1e6]))
    got = tglo._nearfar_veto(res, GLO_N)
    want = jglo._nearfar_veto(jacq.AcquisitionResult(
        *[jnp.asarray(f.numpy()) for f in res]), GLO_N)
    np.testing.assert_array_equal(got.acquired.numpy(),
                                  np.asarray(want.acquired))
    assert got.acquired.tolist() == [True, False, True, False]
