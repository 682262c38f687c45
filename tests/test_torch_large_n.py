"""Kernels B1, B3 and B2 above 16384 points, and the sizes the port took
last (n = 128; std with prime factors up to 1021 and up to 262144): the
port against the JAX package, on the CPU.

Above 16384 a row no longer fits one block on the card, and kernels B1, B3
and B2 run the four-step FFT of csrc/fft_large.cuh (B1 and B3's correlate
stage in one thread-block cluster per cell up to 131072). Here (no card)
their wrappers take their plain versions, so these tests hold:
- the four-step's index arithmetic (`fft_plan.four_step_*`, the NumPy twin
  of the column and row passes) against np.fft, at the sizes whose
  factorizations differ (n1 = 2, 4, 8, 16; n2 a register or a
  shared-memory size): within 2e-6 of the largest value (float32 sums);
  the cluster's column split (`fft_plan.cluster_correlate`) to the same
  tolerance in tests/test_torch_fft_plan.py;
- the port's plain versions against the JAX package on the same seeded
  inputs: the PCF surface (rtol 2e-4, atol 2e-4 * max) and its statistics
  (max and sums rtol 1e-4, arg-lag exact) at 32768 against the Pallas PCF
  kernel in interpret mode and the XLA surface; the std search at 32768
  (v3), 32000 (v1 only) and 65536 (v2) against those Pallas layouts in
  interpret mode and XLA; Welch at nperseg 32768 and 131072 against the
  Pallas kernel in interpret mode (rtol 1e-4, atol 1e-6 * max); the PCF
  surface and statistics at n = 128 and the std search at 128, 16768 =
  131 * 128 (v1) and 160000 (v1, Galileo E1B at 40 MS/s), to the same
  tolerances;
- the gates over every n from 1 to 262144, at 32 and 36 PRNs: wherever a
  Pallas kernel of the JAX package runs, the port launches its kernel; the
  surface is plain only where the JAX package computes XLA; above 262144
  std raises where v1 takes n, and `unsupported_reason` names the cap;
- Galileo E1B acquisition at 8.192 MS/s on the first 40 ms of the JAX
  package's 13 s fixture, re-rendered by the port's simulator: the port's
  `acquire_all` equals the JAX package's (decisions, lags and Dopplers
  exact; ratio, C/N0 and power rtol 1e-4).
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_jamming_tpu.config import AcquisitionConfig as JAcquisitionConfig
from gps_jamming_tpu.models.receiver import acquisition as jacq
from gps_jamming_tpu.models.receiver import galileo as jgal
from gps_jamming_tpu.ops import caf as jcaf
from gps_jamming_tpu.ops import cplx, pallas_caf, pallas_psd
from gps_jamming_tpu_torch import convert
from gps_jamming_tpu_torch.config import AcquisitionConfig
from gps_jamming_tpu_torch.kernels import build, fft_plan, gates
from gps_jamming_tpu_torch.models.receiver import acquisition as tacq
from gps_jamming_tpu_torch.ops import caf as tcaf
from gps_jamming_tpu_torch.ops import cuda_caf, cuda_pcf, cuda_psd
from gps_jamming_tpu_torch.sim import constellation as con

torch.set_num_threads(2)

FOUR_STEP_N = (20480, 32000, 32768, 65536, 131072, 160000, 261376)


def _rows(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _jb(x):
    return cplx.CArray(jnp.asarray(x.real.copy()), jnp.asarray(x.imag.copy()))


def _surf_close(got, want):
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4 * want.max())


@pytest.mark.parametrize("n", FOUR_STEP_N)
def test_four_step_matches_numpy_fft(n):
    """The forward passes leave X[k1 + n1*k2] at [k1*n2 + k2]; the
    correlate stage's inverse passes on that order give |ifft(Y * rep
    shifted)|^2 * n^2 in natural lag order, for shifts of both signs."""
    x = _rows((2, n), seed=n)
    want = np.fft.fft(x.astype(np.complex128))
    got = fft_plan.four_step_forward(x)
    np.testing.assert_allclose(fft_plan.four_step_depermute(got), want,
                               rtol=0, atol=2e-6 * np.abs(want).max())
    rep = _rows(n, seed=n + 1)
    for shift in (-3, 0, 7):
        corr = np.abs(np.fft.ifft(want[0] * np.roll(rep, shift)) * n) ** 2
        np.testing.assert_allclose(
            fft_plan.four_step_correlate(got[0], rep, shift), corr, rtol=0,
            atol=2e-6 * corr.max())


def test_large_split_covers_every_size_the_gates_take():
    """Every n above 16384 that a gate takes (B3 up to 262144, B2 up to
    131072) splits into n1 in (2, 4, 8, 16) and n2 <= 16384 with prime
    factors <= 1021, n1 = 16 exactly above 131072; the correlate stage of
    every such n up to 131072 runs in one thread-block cluster
    (`fft_plan.cluster_split`: n1 CTAs within 227 KB of shared memory
    each), above it on the two passes; the row tables exist for the
    register sizes (GJT_LARGE_REG_SIZES) and the shared-memory ones."""
    sizes = [n for n in range(16385, build.FFT_STD_MAX_N + 1)
             if cuda_caf.supported(n) or cuda_psd.supported(n)]
    assert len(sizes) == 1783
    assert sum(n <= build.FFT_LARGE_MAX_N for n in sizes) == 896
    for n in sizes:
        n1, n2 = fft_plan.large_split(n)
        assert n1 in (2, 4, 8, 16) and n1 * n2 == n and n2 <= build.FFT_MAX_N
        assert (n1 == 16) == (n > build.FFT_LARGE_MAX_N)
        assert gates.small_primes(n2, build.FFT_ROW_MAX_RADIX)
        assert (fft_plan.cluster_split(n) == (n1, n2)) == (n1 <= 8), n
    assert max(fft_plan.cluster_smem_bytes(8, n2)
               for n2 in range(8193, 16385)) \
        == fft_plan.cluster_smem_bytes(8, 16384) <= fft_plan.SMEM_PER_BLOCK
    assert fft_plan.LARGE_REG_SIZES == (10240, 12288, 14336, 16384)
    assert fft_plan.large_split(32768) == (2, 16384)
    assert fft_plan.large_split(32000) == (2, 16000)
    assert fft_plan.large_split(131072) == (8, 16384)
    assert fft_plan.large_split(130304) == (8, 16288)        # 32 * 509
    assert fft_plan.large_split(261376) == (16, 16336)       # 16 * 1021
    assert build.large_row_twiddles(32768, "cpu").shape == (256 + 64,)
    assert build.large_row_twiddles(32000, "cpu").shape == (8000,)
    assert build.large_row_twiddles(261376, "cpu").shape == (8168,)
    assert fft_plan.large_twiddle(32768, 12345).dtype == np.complex64


def test_pcf_surface_at_32768_matches_jax():
    """B1's plain version at Galileo E1B's 32768 lags (8.192 MS/s), 2 PRNs,
    2 code periods, +/-1 kHz (9 coarse bins), against the Pallas PCF kernel
    in interpret mode and the XLA surface."""
    fs, n = 8.192e6, 32768
    x = _rows((2, n), seed=1)
    planes = (np.random.default_rng(2).standard_normal((2, n)).astype(
        np.float32), np.random.default_rng(3).standard_normal((2, n)).astype(
        np.float32))
    want = np.asarray(pallas_caf.caf_accumulate_pcf_fused(
        _jb(x), cplx.CArray(*planes), fs, max_doppler_hz=1000.0,
        precision="f32", interpret=True))
    xla = np.asarray(jcaf.caf_accumulate_pcf(
        _jb(x), cplx.CArray(jnp.asarray(planes[0]), jnp.asarray(planes[1])),
        fs, max_doppler_hz=1000.0))
    before = build.LAUNCHES["pcf"]
    got = cuda_pcf.caf_accumulate_pcf_fused(
        torch.from_numpy(x), convert.replica_from_jax(planes, "cpu"), fs,
        max_doppler_hz=1000.0).numpy()
    assert build.LAUNCHES["pcf"] == before          # no kernel on the CPU
    assert got.shape == want.shape == (2, 54, n)
    _surf_close(got, want)
    _surf_close(got, xla)


@pytest.mark.parametrize("excl", [16, -1])
def test_pcf_stats_at_32768_match_jax(excl):
    """B1's statistics (and peak-only) at 32768 against the Pallas kernel's
    in-kernel statistics in interpret mode."""
    fs, n = 8.192e6, 32768
    x = _rows((2, n), seed=4)
    planes = tuple(np.random.default_rng(s).standard_normal((2, n)).astype(
        np.float32) for s in (5, 6))
    want = [np.asarray(s) for s in pallas_caf.caf_accumulate_pcf_fused(
        _jb(x), cplx.CArray(*planes), fs, max_doppler_hz=1000.0,
        precision="f32", interpret=True, stats_excl=excl)]
    got = [s.numpy() for s in cuda_pcf.caf_accumulate_pcf_fused(
        torch.from_numpy(x), convert.replica_from_jax(planes, "cpu"), fs,
        max_doppler_hz=1000.0, stats_excl=excl)]
    assert all(g.shape == w.shape == (2, 54) for g, w in zip(got, want))
    np.testing.assert_array_equal(got[1], want[1])            # arg-lag
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    for i in (2, 3, 4):
        if excl < 0:
            assert not got[i].any() and not want[i].any()
        else:
            np.testing.assert_allclose(got[i], want[i], rtol=1e-4)


@pytest.mark.parametrize("n,kinds", [(32768, ("v3", "v2", "v1")),
                                     (32000, ("v1",)),
                                     (65536, ("v2", "v1"))])
def test_std_search_above_16384_matches_jax(n, kinds):
    """B3's plain version against every Pallas layout that takes n
    (interpret mode; 32000 = 250 * 128 only v1's) and the XLA search: 2
    PRNs, 5 Doppler bins, 2 code periods."""
    fs = n / 4e-3
    x = _rows((2, n), seed=n + 10)
    planes = tuple(np.random.default_rng(n + s).standard_normal(
        (2, n)).astype(np.float32) for s in (11, 12))
    freqs = jcaf.doppler_bins(500.0, 250.0)
    assert (jcaf.fused_dispatch(n, 2) or "") in kinds
    before = build.LAUNCHES["caf_std"]
    got = tcaf.caf_accumulate(torch.from_numpy(x),
                              convert.replica_from_jax(planes, "cpu"), freqs,
                              fs).numpy()
    assert build.LAUNCHES["caf_std"] == before
    assert got.shape == (2, 5, n)
    fns = {"v1": pallas_caf.caf_accumulate_fused,
           "v2": pallas_caf.caf_accumulate_fused_v2,
           "v3": pallas_caf.caf_accumulate_fused_v3}
    for kind in kinds:
        if kind == "v2" and not pallas_caf.supported_v2(n):
            continue
        want = np.asarray(fns[kind](_jb(x), cplx.CArray(*planes), freqs, fs,
                                    precision="f32", freq_tile=4,
                                    interpret=True))
        _surf_close(got, want)
    xla = np.asarray(jcaf.caf_accumulate(
        _jb(x), cplx.CArray(jnp.asarray(planes[0]), jnp.asarray(planes[1])),
        freqs, fs))
    _surf_close(got, xla)


@pytest.mark.parametrize("nperseg", [32768, 131072])
def test_welch_above_16384_matches_jax(nperseg):
    """B2's plain version against the Pallas Welch kernel in interpret mode
    over 4.5 segments' worth of samples with a DC offset of 0.3 - 0.2j."""
    x = (_rows(9 * nperseg // 2 + 77, seed=nperseg) + (0.3 - 0.2j)).astype(
        np.complex64)
    want = np.asarray(pallas_psd.welch_psd_fused(
        cplx.asarray(jnp.asarray(x)), 2.048e6, nperseg, interpret=True))
    before = build.LAUNCHES["welch_psd"]
    got = cuda_psd.welch_psd_fused(torch.from_numpy(x), 2.048e6,
                                   nperseg).numpy()
    assert build.LAUNCHES["welch_psd"] == before
    assert got.shape == want.shape == (nperseg,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * want.max())


@pytest.mark.parametrize("excl", [None, 4, -1])
def test_pcf_at_128_matches_jax(excl):
    """B1's plain version at n = 128 (GPS at 128 kS/s, 1 kHz bins, +/-7
    kHz: 15 coarse bins), 2 PRNs, 2 code periods, against the Pallas PCF
    kernel (v3, 1 x 128) in interpret mode: the surface (rtol 2e-4, atol
    2e-4 * max; also against XLA), the statistics and peak-only (max and
    sums rtol 1e-4, arg-lag exact)."""
    fs, n = 128e3, 128
    x = _rows((2, n), seed=128)
    planes = tuple(np.random.default_rng(s).standard_normal((2, n)).astype(
        np.float32) for s in (129, 130))
    assert pallas_caf.supported_pcf(n, 2) and cuda_pcf.supported(n)
    want = pallas_caf.caf_accumulate_pcf_fused(
        _jb(x), cplx.CArray(*planes), fs, precision="f32", interpret=True,
        stats_excl=excl)
    before = build.LAUNCHES["pcf"]
    got = cuda_pcf.caf_accumulate_pcf_fused(
        torch.from_numpy(x), convert.replica_from_jax(planes, "cpu"), fs,
        stats_excl=excl)
    assert build.LAUNCHES["pcf"] == before
    if excl is None:
        want = np.asarray(want)
        assert got.shape == want.shape == (2, 90, n)
        _surf_close(got.numpy(), want)
        xla = np.asarray(jcaf.caf_accumulate_pcf(
            _jb(x), cplx.CArray(jnp.asarray(planes[0]),
                                jnp.asarray(planes[1])), fs))
        _surf_close(got.numpy(), xla)
        return
    want = [np.asarray(w) for w in want]
    got = [g.numpy() for g in got]
    assert all(g.shape == w.shape == (2, 90) for g, w in zip(got, want))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    for i in (2, 3, 4):
        if excl < 0:
            assert not got[i].any() and not want[i].any()
        else:
            np.testing.assert_allclose(got[i], want[i], rtol=1e-4)


@pytest.mark.parametrize("n,kind", [(128, "v3"), (16768, "v1"),
                                    (160000, "v1")])
def test_std_search_at_the_sizes_taken_last_matches_jax(n, kind):
    """B3's plain version at the sizes the port's kernel took last, each
    against the Pallas layout `fused_dispatch` picks (interpret mode) and
    the XLA search: 128 (v3's 1 x 128), 16768 = 131 * 128 (v1; Galileo E1B
    at 4.192 MS/s, a prime factor above 127) and 160000 (v1; Galileo E1B's
    4 ms at 40 MS/s, n1 = 16 on the card): 2 PRNs, 5 Doppler bins, 2 code
    periods, rtol 2e-4, atol 2e-4 * max."""
    fs = n / 4e-3
    x = _rows((2, n), seed=n + 10)
    planes = tuple(np.random.default_rng(n + s).standard_normal(
        (2, n)).astype(np.float32) for s in (11, 12))
    freqs = jcaf.doppler_bins(500.0, 250.0)
    assert jcaf.fused_dispatch(n, 2) == kind and cuda_caf.supported(n)
    before = build.LAUNCHES["caf_std"]
    got = tcaf.caf_accumulate(torch.from_numpy(x),
                              convert.replica_from_jax(planes, "cpu"), freqs,
                              fs).numpy()
    assert build.LAUNCHES["caf_std"] == before
    assert got.shape == (2, 5, n)
    fn = {"v1": pallas_caf.caf_accumulate_fused,
          "v3": pallas_caf.caf_accumulate_fused_v3}[kind]
    want = np.asarray(fn(_jb(x), cplx.CArray(*planes), freqs, fs,
                         precision="f32", freq_tile=4, interpret=True))
    _surf_close(got, want)
    xla = np.asarray(jcaf.caf_accumulate(
        _jb(x), cplx.CArray(jnp.asarray(planes[0]), jnp.asarray(planes[1])),
        freqs, fs))
    _surf_close(got, xla)


def _route(n: int, n_prn: int, pcf: bool) -> str:
    """Where a search of n lags goes on a CUDA tensor: the kernel, the
    plain surface (`caf.plain_on_card`) or the wrapper's ValueError."""
    ours = cuda_pcf.supported(n) if pcf else cuda_caf.supported(n)
    card = types.SimpleNamespace(is_cuda=True, shape=(10, n))
    if tcaf.plain_on_card(card, n_prn, pcf):
        assert not ours
        return "plain"
    return "kernel" if ours else "raise"


@pytest.mark.parametrize("n_prn", [32, 36])
def test_gates_match_the_tpu_kernels_from_16385_to_262144(n_prn):
    """For every n in (16384, 262144], at 32 and 36 PRNs (GPS, Galileo):
    PCF launches B1 exactly where `pallas_caf.supported_pcf` runs the
    Pallas kernel (20480-32768) and is plain elsewhere; std launches B3
    wherever `fused_dispatch` runs a Pallas layout (v3, v2 or v1, prime
    factors up to 1021) and is plain only where it runs XLA; Welch
    launches B2 exactly at the nperseg of `pallas_psd.supported`. Above
    262144 std raises where v1 takes n (128 * 3 * 683, 2 * 128 * 1031
    ...), and `unsupported_reason` names the cap."""
    routes = {"pcf": {}, "std": {}}
    for n in range(16385, build.FFT_STD_MAX_N + 1):
        tpu_pcf = pallas_caf.supported_pcf(n, n_prn)
        tpu_std = jcaf.fused_dispatch(n, n_prn) is not None
        r = _route(n, n_prn, pcf=True)
        assert r == ("kernel" if tpu_pcf else "plain"), n
        routes["pcf"][r] = routes["pcf"].get(r, 0) + 1
        r = _route(n, n_prn, pcf=False)
        assert r != "raise" and (r == "kernel" or not tpu_std), n
        routes["std"][r] = routes["std"].get(r, 0) + 1
        if n <= build.FFT_LARGE_MAX_N:
            assert cuda_psd.supported(n) == pallas_psd.supported(n), n
    assert routes["pcf"] == {"kernel": 4, "plain": 245756}
    assert routes["std"] == {"kernel": 1783, "plain": 243977}
    raised = [n for n in range(build.FFT_STD_MAX_N + 1,
                               build.FFT_STD_MAX_N + 4097)
              if _route(n, n_prn, pcf=False) == "raise"]
    assert raised[0] == build.FFT_STD_MAX_N + 128 == 128 * 3 * 683
    assert 2 * 128 * 1031 in raised and all(
        jcaf.fused_dispatch(n, n_prn) == "v1" for n in raised)
    assert cuda_caf.unsupported_reason(raised[0]).endswith(
        "is above 262144, the cap of kernel B3's four-step FFT")


@pytest.mark.parametrize("n_prn", [32, 36])
def test_gates_below_16385_raise_only_where_a_tpu_kernel_alone_applies(
        n_prn):
    """For every n in [1, 16384], PCF and std at 32 and 36 PRNs: wherever a
    Pallas kernel takes n, the port launches its kernel (n = 128 too: v3's
    1 x 128, the register FFT's 128-point schedule), so no n raises; the
    surface is plain only where no Pallas kernel takes n."""
    taken = {True: 0, False: 0}
    for n in range(1, build.FFT_MAX_N + 1):
        for pcf in (True, False):
            tpu = (pallas_caf.supported_pcf(n, n_prn) if pcf
                   else jcaf.fused_dispatch(n, n_prn) is not None)
            r = _route(n, n_prn, pcf)
            assert r != "raise", (n, pcf)
            assert r == "kernel" if tpu else True, (n, pcf)
            taken[pcf] += tpu
    assert _route(128, n_prn, True) == _route(128, n_prn, False) == "kernel"
    assert _route(127, n_prn, True) == "plain"
    assert taken[True] > 0 and taken[False] > taken[True]


GAL_FS = 8.192e6
GAL_N = 32768                       # one 4 ms code period at 8.192 MS/s
GAL_CFG = AcquisitionConfig(doppler_max_hz=4000.0, doppler_step_hz=250.0)
J_GAL_CFG = JAcquisitionConfig(**dataclasses.asdict(GAL_CFG))


def _galileo_40ms():
    """The first 40 ms of the JAX package's 13 s E1B fixture
    (tests/test_multiconstellation_e2e.py: shell at ToE 345600, receiver at
    (50.06, 19.94, 219), ToW0 ToE - 1.3 s, noise 0.4, seed 2), rendered at
    8.192 MS/s by the port's simulator: (10, 32768) complex64 and the
    truths."""
    x, truths, _ = con.simulate_galileo_constellation(
        con.galileo_shell(345600.0), (50.06, 19.94, 219.0), 345600.0 - 1.3,
        10 * GAL_N, GAL_FS, noise_std=0.4, seed=2)
    return x.astype(np.complex64).reshape(10, GAL_N), truths


@pytest.mark.parametrize("method", ["std", "pcf"])
def test_galileo_acquisition_at_8192_khz_matches_jax(method):
    """The port's acquire_all (plain versions of B3 and B1 on the CPU)
    against the JAX package's on 10 code periods of 32768 samples, four
    PRNs in view and two not, +/-4 kHz: the same decisions, lags and
    Dopplers; the PRNs in view acquired, by std within 150 Hz of their
    truth (the PCF's labels alias at 4 ms blocks in both packages, C6:
    `refine_doppler` recovers them)."""
    x, truths = _galileo_40ms()
    truth = {t.prn: t.doppler_hz for t in truths}
    in_view = sorted(truth)[:4]
    absent = [p for p in range(1, 37) if p not in truth][:2]
    prns = in_view + absent
    planes = jgal.replica_table_host(GAL_FS, GAL_N, prns)
    kw = dict(code_period_s=jgal.PERIOD_S,
              code_len_chips=float(jgal.BOC_LEN), method=method)
    want = jacq.acquire_all(
        _jb(x), cplx.CArray(jnp.asarray(planes.re), jnp.asarray(planes.im)),
        GAL_FS, J_GAL_CFG, **kw)
    got = tacq.acquire_all(torch.from_numpy(x),
                           convert.replica_from_jax(planes, "cpu"), GAL_FS,
                           GAL_CFG, **kw)
    for f in ("acquired", "code_phase", "doppler_hz"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    for f in ("peak_ratio", "cn0_dbhz", "peak_power"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-4)
    assert got.acquired.tolist() == [True] * 4 + [False] * 2
    if method == "std":
        for i, p in enumerate(in_view):
            assert abs(float(got.doppler_hz[i]) - truth[p]) <= 150.0, p
