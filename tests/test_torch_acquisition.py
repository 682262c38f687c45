"""Port acquisition (models.receiver.acquisition, ops.codes, convert) vs the
JAX package.

A synthetic 10-period GPS block with one injected PRN goes through both
`acquire_all(method='pcf')`; acquired / code phase / Doppler must be equal,
peak ratio and C/N0 within rtol 1e-4. The replica builders are bit-equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_jamming_tpu.config import AcquisitionConfig
from gps_jamming_tpu.models.receiver import acquisition as jacq
from gps_jamming_tpu.ops import caf as jcaf
from gps_jamming_tpu.ops import codes as jcodes
from gps_jamming_tpu.ops import cplx, pallas_caf
from gps_jamming_tpu_torch import convert
from gps_jamming_tpu_torch.models.receiver import acquisition as tacq
from gps_jamming_tpu_torch.ops import codes as tcodes
from gps_jamming_tpu_torch.ops import cuda_pcf

torch.set_num_threads(2)

FS = 2.048e6
N = 2048
N_PRN = 8
CFG = AcquisitionConfig()


def _block(prn=3, code_phase=700, doppler_hz=2350.0, seed=21):
    """10 code periods: unit complex noise + one PRN at ~45 dB-Hz."""
    rng = np.random.default_rng(seed)
    i = np.arange(10 * N)
    chip = np.floor((i - code_phase) * (1.023e6 / FS)).astype(int) % 1023
    amp = np.sqrt(2 * 10 ** (-18 / 10))
    x = (rng.standard_normal(i.size) + 1j * rng.standard_normal(i.size)
         + amp * jcodes.gps_ca_code(prn)[chip]
         * np.exp(2j * np.pi * doppler_hz * i / FS))
    return x.astype(np.complex64).reshape(10, N)


def _replica_planes():
    rep = jacq.gps_replica_table_host(FS, N)
    return rep.re[:N_PRN], rep.im[:N_PRN]


def _assert_same_result(got, want):
    for f in ("acquired", "code_phase", "doppler_hz"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    for f in ("peak_ratio", "cn0_dbhz", "peak_power"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-4)


def test_acquire_all_pcf_matches_jax():
    x = _block()
    planes = _replica_planes()
    want = jacq.acquire_all(
        cplx.CArray(jnp.asarray(x.real.copy()), jnp.asarray(x.imag.copy())),
        cplx.CArray(jnp.asarray(planes[0]), jnp.asarray(planes[1])), FS, CFG,
        method="pcf")
    got = tacq.acquire_all(torch.from_numpy(x),
                           convert.replica_from_jax(planes), FS, CFG,
                           method="pcf")
    _assert_same_result(got, want)
    assert got.acquired.tolist() == [p == 2 for p in range(N_PRN)]
    assert int(got.code_phase[2]) == 700
    assert abs(float(got.doppler_hz[2]) - 2350.0) <= 150.0


def test_acquire_all_auto_resolves_to_pcf_for_gps():
    x = torch.from_numpy(_block(seed=22))
    rep = convert.replica_from_jax(_replica_planes())
    a = tacq.acquire_all(x, rep, FS, CFG, method="auto")
    b = tacq.acquire_all(x, rep, FS, CFG, method="pcf")
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f))


def test_acquisition_tests_match_jax_on_the_same_inputs():
    """acquisition_test on one surface and acquisition_test_from_stats on
    the Pallas kernel's stats (interpret mode), each fed to both sides."""
    x = _block(prn=5, code_phase=100, doppler_hz=-4100.0, seed=23)
    planes = _replica_planes()
    jb = cplx.CArray(jnp.asarray(x.real.copy()), jnp.asarray(x.imag.copy()))
    excl = tacq.exclusion_half_width(N, CFG)
    surf = pallas_caf.caf_accumulate_pcf_fused(
        jb, cplx.CArray(*planes), FS, precision="f32", interpret=True)
    stats = pallas_caf.caf_accumulate_pcf_fused(
        jb, cplx.CArray(*planes), FS, precision="f32", interpret=True,
        stats_excl=excl)
    freqs = jcaf.pcf_doppler_hz(FS, N, CFG.doppler_max_hz)
    want = jacq.acquisition_test(surf, jnp.asarray(freqs), FS, CFG, 5e-3)
    got = tacq.acquisition_test(convert.surface_from_jax(surf),
                                torch.from_numpy(freqs), FS, CFG, 5e-3)
    _assert_same_result(got, want)
    want = jacq.acquisition_test_from_stats(stats, jnp.asarray(freqs), N,
                                            CFG, 5e-3)
    got = tacq.acquisition_test_from_stats(convert.stats_from_jax(stats),
                                           torch.from_numpy(freqs), N, CFG,
                                           5e-3)
    _assert_same_result(got, want)
    assert bool(got.acquired[4]) and int(got.code_phase[4]) == 100
    # the port's own stats path gives the same decision
    own = tacq.acquisition_test_from_stats(
        cuda_pcf.caf_accumulate_pcf_fused(
            torch.from_numpy(x), convert.replica_from_jax(planes), FS,
            stats_excl=excl), torch.from_numpy(freqs), N, CFG, 5e-3)
    _assert_same_result(own, want)


def test_std_search_and_bad_exclusion_raise():
    rep = torch.zeros(2, N, dtype=torch.complex64)
    with pytest.raises(NotImplementedError, match="B3"):
        tacq.acquire_all(torch.zeros(10, N, dtype=torch.complex64), rep, FS,
                         CFG, method="std")
    with pytest.raises(NotImplementedError, match="B3"):
        # Galileo E1B geometry: 'auto' resolves to the std search
        tacq.acquire_all(torch.zeros(4, 16384, dtype=torch.complex64),
                         torch.zeros(2, 16384, dtype=torch.complex64),
                         4.096e6, CFG, method="auto")
    with pytest.raises(ValueError):
        tacq.exclusion_half_width(N, AcquisitionConfig(exclude_chips=600.0))
    assert tacq.exclusion_half_width(N, CFG) == 4


def test_codes_and_replica_are_bit_equal_to_jax():
    for prn in range(1, 33):
        np.testing.assert_array_equal(tcodes.gps_ca_code(prn),
                                      jcodes.gps_ca_code(prn))
    np.testing.assert_array_equal(tcodes.ca_code_from_delay(145),
                                  jcodes.ca_code_from_delay(145))
    re, im = tcodes.gps_replica_table_host(FS, N)
    want = jacq.gps_replica_table_host(FS, N)
    np.testing.assert_array_equal(re, want.re)
    np.testing.assert_array_equal(im, want.im)
    t = tcodes.gps_replica_table(FS, N, "cpu")
    assert t.dtype == torch.complex64 and tuple(t.shape) == (32, N)
    np.testing.assert_array_equal(t.real.numpy(), want.re)
    np.testing.assert_array_equal(t.imag.numpy(), want.im)


def test_replica_conversion_round_trip():
    want = jacq.gps_replica_table_host(FS, 1024)
    t = convert.replica_from_jax(want, "cpu")
    assert t.dtype == torch.complex64
    np.testing.assert_array_equal(t.real.numpy(), want.re)
    np.testing.assert_array_equal(t.imag.numpy(), want.im)
    t2 = convert.replica_from_jax((want.re, want.im))
    assert torch.equal(t, t2)
