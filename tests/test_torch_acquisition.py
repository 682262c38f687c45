"""Port acquisition (models.receiver.acquisition, ops.codes, convert) vs the
JAX package.

A synthetic 10-period GPS (or SBAS) block with one injected PRN goes
through both `acquire_all` (method 'pcf', 'std' or 'auto'); acquired / code
phase / Doppler must be equal, peak ratio, C/N0 and peak power within rtol
1e-4. The replica builders are bit-equal. `refine_doppler` agrees within
0.5 Hz (float32 sums in another order under an arctan2).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_jamming_tpu.config import AcquisitionConfig as JAcquisitionConfig
from gps_jamming_tpu.models.receiver import acquisition as jacq
from gps_jamming_tpu.ops import caf as jcaf
from gps_jamming_tpu.ops import codes as jcodes
from gps_jamming_tpu.ops import cplx, pallas_caf
from gps_jamming_tpu_torch import convert
from gps_jamming_tpu_torch.config import AcquisitionConfig
from gps_jamming_tpu_torch.models.receiver import acquisition as tacq
from gps_jamming_tpu_torch.ops import caf as tcaf
from gps_jamming_tpu_torch.ops import codes as tcodes
from gps_jamming_tpu_torch.ops import cuda_caf, cuda_pcf

torch.set_num_threads(2)

FS = 2.048e6
N = 2048
N_PRN = 8
CFG = AcquisitionConfig()             # the port's config
JCFG = JAcquisitionConfig()           # the JAX package's, same defaults


def _block(prn=3, code_phase=700, doppler_hz=2350.0, seed=21, code=None,
           n_periods=10):
    """n_periods code periods: unit complex noise + one PRN (GPS unless
    `code` is given) at ~45 dB-Hz."""
    rng = np.random.default_rng(seed)
    code = jcodes.gps_ca_code(prn) if code is None else code
    i = np.arange(n_periods * N)
    chip = np.floor((i - code_phase) * (1.023e6 / FS)).astype(int) % 1023
    amp = np.sqrt(2 * 10 ** (-18 / 10))
    x = (rng.standard_normal(i.size) + 1j * rng.standard_normal(i.size)
         + amp * code[chip] * np.exp(2j * np.pi * doppler_hz * i / FS))
    return x.astype(np.complex64).reshape(n_periods, N)


def _jax_blocks(x):
    return cplx.CArray(jnp.asarray(x.real.copy()), jnp.asarray(x.imag.copy()))


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
        cplx.CArray(jnp.asarray(planes[0]), jnp.asarray(planes[1])), FS,
        JCFG,
        method="pcf")
    got = tacq.acquire_all(torch.from_numpy(x),
                           convert.replica_from_jax(planes, "cpu"), FS, CFG,
                           method="pcf")
    _assert_same_result(got, want)
    assert got.acquired.tolist() == [p == 2 for p in range(N_PRN)]
    assert int(got.code_phase[2]) == 700
    assert abs(float(got.doppler_hz[2]) - 2350.0) <= 150.0


def test_acquire_all_auto_resolves_to_pcf_for_gps():
    x = torch.from_numpy(_block(seed=22))
    rep = convert.replica_from_jax(_replica_planes(), "cpu")
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
    freqs = jcaf.pcf_doppler_hz(FS, N, JCFG.doppler_max_hz)
    want = jacq.acquisition_test(surf, jnp.asarray(freqs), FS, JCFG, 5e-3)
    got = tacq.acquisition_test(convert.surface_from_jax(surf, "cpu"),
                                torch.from_numpy(freqs), FS, CFG, 5e-3)
    _assert_same_result(got, want)
    want = jacq.acquisition_test_from_stats(stats, jnp.asarray(freqs), N,
                                            JCFG, 5e-3)
    got = tacq.acquisition_test_from_stats(
        convert.stats_from_jax(stats, "cpu"), torch.from_numpy(freqs), N,
        CFG, 5e-3)
    _assert_same_result(got, want)
    assert bool(got.acquired[4]) and int(got.code_phase[4]) == 100
    # the port's own stats path gives the same decision
    own = tacq.acquisition_test_from_stats(
        cuda_pcf.caf_accumulate_pcf_fused(
            torch.from_numpy(x), convert.replica_from_jax(planes, "cpu"), FS,
            stats_excl=excl), torch.from_numpy(freqs), N, CFG, 5e-3)
    _assert_same_result(own, want)


def test_std_search_and_bad_exclusion_raise():
    """acquire_all(method='std') for GPS (kernel B3's plain version, 71
    bins x 10 periods, 8 PRNs) matches the JAX package; a bad exclusion
    window and an unknown method raise."""
    x = _block(prn=6, code_phase=1500, doppler_hz=-3350.0, seed=24)
    planes = _replica_planes()
    want = jacq.acquire_all(
        _jax_blocks(x),
        cplx.CArray(jnp.asarray(planes[0]), jnp.asarray(planes[1])), FS,
        JCFG,
        method="std")
    got = tacq.acquire_all(torch.from_numpy(x),
                           convert.replica_from_jax(planes, "cpu"), FS, CFG,
                           method="std")
    _assert_same_result(got, want)
    assert got.acquired.tolist() == [p == 5 for p in range(N_PRN)]
    assert int(got.code_phase[5]) == 1500
    assert float(got.doppler_hz[5]) == -3400.0          # the 200 Hz grid
    with pytest.raises(ValueError):
        tacq.acquire_all(torch.from_numpy(x),
                         convert.replica_from_jax(planes, "cpu"), FS, CFG,
                         method="fft")
    with pytest.raises(ValueError):
        tacq.exclusion_half_width(N, AcquisitionConfig(exclude_chips=600.0))
    assert tacq.exclusion_half_width(N, CFG) == 4


@pytest.mark.parametrize("n,nb,fs,pcf", [
    (2048, 10, 2.048e6, True),      # GPS: 15 coarse bins, 180 vs 710 rows
    (16384, 10, 4.096e6, True),     # Galileo E1B: 684 vs 710 rows
    (16384, 9, 4.096e6, False),     # 684 vs 639: std from 9 periods down
    (16384, 4, 4.096e6, False),
])
def test_auto_resolution_matches_jax(n, nb, fs, pcf):
    """'auto' takes PCF where it runs fewer inverse-FFT rows, in both
    packages; at 16384 lags and +/-7 kHz std wins only for n_blocks <= 9."""
    nf = jcaf.doppler_bins(CFG.doppler_max_hz, CFG.doppler_step_hz).size
    args = (n, nb, fs, CFG.doppler_max_hz, nf)
    assert tcaf.pcf_profitable(*args) is pcf
    assert jcaf.pcf_profitable(*args) is pcf


def test_auto_resolving_to_std_runs_the_std_search():
    rng = np.random.default_rng(25)
    x = torch.from_numpy((rng.standard_normal((2, N))
                          + 1j * rng.standard_normal((2, N))).astype(
        np.complex64))
    rep = convert.replica_from_jax(_replica_planes(), "cpu")[:2]
    # 2 GPS periods: 180 PCF rows against 71 * 2 = 142 std rows
    assert not tcaf.pcf_profitable(N, 2, FS, CFG.doppler_max_hz, 71)
    a = tacq.acquire_all(x, rep, FS, CFG, method="auto")
    b = tacq.acquire_all(x, rep, FS, CFG, method="std")
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f))


def test_sbas_std_acquisition_matches_jax():
    """SBAS PRN 124 among PRNs 120-127 (the replica table of
    `sbas_replica_table_host`), std search."""
    x = _block(code_phase=321, doppler_hz=1800.0, seed=26,
               code=jcodes.sbas_ca_code(124))
    re, im = tacq.sbas_replica_table_host(FS, N)
    planes = (re[:8], im[:8])
    want = jacq.acquire_all(
        _jax_blocks(x),
        cplx.CArray(jnp.asarray(planes[0]), jnp.asarray(planes[1])), FS,
        JCFG,
        method="std")
    got = tacq.acquire_all(torch.from_numpy(x),
                           convert.replica_from_jax(planes, "cpu"), FS, CFG,
                           method="std")
    _assert_same_result(got, want)
    assert got.acquired.tolist() == [p == 4 for p in range(8)]
    assert int(got.code_phase[4]) == 321
    assert float(got.doppler_hz[4]) == 1800.0


def test_refine_doppler_matches_jax():
    """Two GPS channels over 40 ms, from their acquired lags and 200 Hz
    grid Dopplers, and a third lag near the end of the capture (its
    window runs into the zero padding)."""
    x = _block(prn=3, code_phase=700, doppler_hz=2350.0, seed=28,
               n_periods=40).reshape(-1)
    i = np.arange(x.size)
    chip = np.floor((i - 1900) * (1.023e6 / FS)).astype(int) % 1023
    x = x + (0.3 * jcodes.gps_ca_code(9)[chip]
             * np.exp(-2j * np.pi * 4125.0 * i / FS)).astype(np.complex64)
    x = x.astype(np.complex64)
    table = jcodes.gps_ca_table()[[2, 8, 2]]
    lags = np.array([700, 1900, x.size - 5000], np.int32)
    dopp = np.array([2400.0, -4200.0, 2400.0], np.float32)
    want = np.asarray(jacq.refine_doppler(
        cplx.CArray(jnp.asarray(x.real.copy()), jnp.asarray(x.imag.copy())),
        table, lags, dopp, FS, 1.023e6))
    got = tacq.refine_doppler(torch.from_numpy(x), table, lags, dopp, FS,
                              1.023e6)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0.5)
    assert abs(float(got[0]) - 2350.0) < 20.0
    assert abs(float(got[1]) + 4125.0) < 20.0


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
    t2 = convert.replica_from_jax((want.re, want.im), "cpu")
    assert torch.equal(t, t2)


def _c1_case(system):
    """(blocks, jax replica planes, port replica, fs, n, kw, cfg pair, the
    injected (index, lag, Hz)) at an n kernel B1 does not take: Galileo
    E1B at 4.192 MS/s (n = 16768 = 131 * 128, a prime factor above 127
    that the JAX package's v1 takes for std, and so B3 since its four-step
    rows take primes up to 1021; no PCF kernel takes it; 3 PRNs, +/-2 kHz
    to keep the CPU surface small) or GPS at 2.062 MS/s (n = 2062 = 2 *
    1031, a prime factor above 1021: no kernel of either package)."""
    from gps_jamming_tpu.models.receiver import galileo as jgal
    if system == "galileo":
        fs, n, prns, hz, lag = 4.192e6, 16768, [4, 11, 19], -1500.0, 5000
        code = jgal.e1b_boc_code(11)
        chip = np.floor((np.arange(10 * n) - lag) * (jgal.BOC_RATE / fs))
        rep = jgal.replica_table_host(fs, n, prns)
        planes = (rep.re, rep.im)
        kw = dict(code_period_s=jgal.PERIOD_S,
                  code_len_chips=float(jgal.BOC_LEN))
        cfgs = (AcquisitionConfig(doppler_max_hz=2000.0),
                JAcquisitionConfig(doppler_max_hz=2000.0))
        want_i = 1
    else:
        fs, n, hz, lag = 2.062e6, 2062, 2600.0, 901
        code = jcodes.gps_ca_code(3)
        chip = np.floor((np.arange(10 * n) - lag) * (1.023e6 / fs))
        rep = jacq.gps_replica_table_host(fs, n)
        planes = (rep.re[:N_PRN], rep.im[:N_PRN])
        kw, cfgs, want_i = {}, (CFG, JCFG), 2
    rng = np.random.default_rng(n)
    i = np.arange(10 * n)
    x = (rng.standard_normal(i.size) + 1j * rng.standard_normal(i.size)
         + np.sqrt(2 * 10 ** (-18 / 10)) * code[chip.astype(int) % code.size]
         * np.exp(2j * np.pi * hz * i / fs)).astype(np.complex64)
    return (x.reshape(10, n), planes, fs, n, kw, cfgs, (want_i, lag, hz))


@pytest.mark.parametrize("system", ["galileo", "gps_prime_1031"])
@pytest.mark.parametrize("method", ["pcf", "std", "auto"])
def test_acquire_all_where_the_kernels_do_not_apply_matches_jax(system,
                                                                method):
    """At an n kernel B1 does not take, the port's CPU search equals the
    JAX package's: its XLA surface at 2062 (no Pallas kernel takes it; the
    card computes the plain surfaces too), its XLA surface on the CPU at
    16768 (a Pallas kernel, v1, on a TPU for std, and B3 on the card, in a
    thread-block cluster with a radix-131 row stage; tests/test_torch_
    cuda.py). Both acquire the same PRN at the same lag and Doppler."""
    x, planes, fs, n, kw, (cfg, jcfg), (want_i, lag, hz) = _c1_case(system)
    assert not cuda_pcf.supported(n)
    assert cuda_caf.supported(n) == (system == "galileo")
    want = jacq.acquire_all(_jax_blocks(x), cplx.CArray(*planes), fs, jcfg,
                            method=method, **kw)
    got = tacq.acquire_all(torch.from_numpy(x),
                           convert.replica_from_jax(planes, "cpu"), fs, cfg,
                           method=method, **kw)
    _assert_same_result(got, want)
    assert got.acquired.tolist() == [p == want_i
                                     for p in range(len(planes[0]))]
    assert abs(int(got.code_phase[want_i]) - lag) <= 1
    assert abs(float(got.doppler_hz[want_i]) - hz) <= 250.0
