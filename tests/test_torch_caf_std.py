"""Port per-Doppler ("std") search (ops.caf, ops.cuda_caf: kernel B3's plain
version) and the FDMA PCF surface vs the JAX package.

The same seeded blocks, replica and Doppler bins go through both. The
references are the three Pallas std kernels in interpret mode with f32
operands (`pallas_caf.caf_accumulate_fused`, `_v2`, `_v3`, as
tests/test_pallas_caf.py runs them) and the XLA `caf.caf_accumulate`.
Tolerance: max|port - JAX| / max(JAX) < 1e-4, the bound of
tests/test_pallas_caf.py (float32 FFTs of other factorizations; the port's
phasors are float64-exact, the JAX package's float32).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_jamming_tpu.ops import caf as jcaf
from gps_jamming_tpu.ops import cplx, pallas_caf
from gps_jamming_tpu_torch import convert
from gps_jamming_tpu_torch.kernels import build
from gps_jamming_tpu_torch.ops import caf as tcaf
from gps_jamming_tpu_torch.ops import cuda_caf

torch.set_num_threads(2)

FS = 2.048e6


def _case(n, nb, nprn, nf, seed):
    """Blocks, replica planes and nf Doppler bins from -2 kHz in 500 Hz
    steps (nf = 5: not a multiple of the Pallas freq tile of 2 or 4)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((nb, n))
         + 1j * rng.standard_normal((nb, n))).astype(np.complex64)
    re = rng.standard_normal((nprn, n)).astype(np.float32)
    im = rng.standard_normal((nprn, n)).astype(np.float32)
    return x, (re, im), jcaf.doppler_bins(2000.0, 500.0)[:nf]


def _jb(x):
    return cplx.CArray(jnp.asarray(x.real.copy()), jnp.asarray(x.imag.copy()))


def _rel_err(got, want):
    return np.max(np.abs(got - want)) / np.max(want)


def _jax_std(kind, x, planes, freqs):
    if kind == "xla":
        rep = cplx.CArray(jnp.asarray(planes[0]), jnp.asarray(planes[1]))
        return np.asarray(jcaf.caf_accumulate(_jb(x), rep, freqs, FS))
    fn = {"v1": pallas_caf.caf_accumulate_fused,
          "v2": pallas_caf.caf_accumulate_fused_v2,
          "v3": pallas_caf.caf_accumulate_fused_v3}[kind]
    return np.asarray(fn(_jb(x), cplx.CArray(*planes), freqs, FS,
                         precision="f32", freq_tile=4, interpret=True))


@pytest.mark.parametrize("kind", ["v1", "v2", "v3", "xla"])
def test_std_search_matches_jax(kind):
    """n = 256 (all three Pallas layouts factor it), 5 bins (padded to 8
    by the freq tile of 4), 3 PRNs (v3 pads them to 64 lanes)."""
    x, planes, freqs = _case(256, 3, 3, 5, seed=31)
    want = _jax_std(kind, x, planes, freqs)
    before = build.LAUNCHES["caf_std"]
    got = tcaf.caf_accumulate(torch.from_numpy(x),
                              convert.replica_from_jax(planes, "cpu"),
                              freqs, FS)
    assert build.LAUNCHES["caf_std"] == before          # no kernel on the CPU
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (3, 5, 256)
    assert _rel_err(got.numpy(), want) < 1e-4


def test_std_search_at_gps_width_matches_xla():
    """The receiver's GPS geometry: 10 periods of 2048, 71 bins, 4 PRNs."""
    rng = np.random.default_rng(32)
    x = (rng.standard_normal((10, 2048))
         + 1j * rng.standard_normal((10, 2048))).astype(np.complex64)
    planes = tuple(rng.standard_normal((4, 2048)).astype(np.float32)
                   for _ in range(2))
    freqs = jcaf.doppler_bins(7000.0, 200.0)
    want = _jax_std("xla", x, planes, freqs)
    got = cuda_caf.caf_accumulate_reference(
        torch.from_numpy(x), convert.replica_from_jax(planes, "cpu"), freqs,
        FS)
    assert tuple(got.shape) == want.shape == (4, 71, 2048)
    assert _rel_err(got.numpy(), want) < 1e-4


@pytest.mark.parametrize("n", [2400, 3200])
def test_std_search_at_rtl_rates_matches_xla(n):
    """Kernel B3's plain version at the non-power-of-two code periods of
    GPS at 2.4 and 3.2 MS/s (n = fs * 1 ms), 71 bins, 3 PRNs, against the
    JAX package's `caf.caf_accumulate` on the CPU."""
    fs = n * 1000.0
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((4, n))
         + 1j * rng.standard_normal((4, n))).astype(np.complex64)
    planes = tuple(rng.standard_normal((3, n)).astype(np.float32)
                   for _ in range(2))
    freqs = jcaf.doppler_bins(7000.0, 200.0)
    rep = cplx.CArray(jnp.asarray(planes[0]), jnp.asarray(planes[1]))
    want = np.asarray(jcaf.caf_accumulate(_jb(x), rep, freqs, fs))
    got = tcaf.caf_accumulate(torch.from_numpy(x),
                              convert.replica_from_jax(planes, "cpu"),
                              freqs, fs)
    assert tuple(got.shape) == want.shape == (3, 71, n)
    assert _rel_err(got.numpy(), want) < 1e-4


@pytest.mark.parametrize("n", [2400, 3200])
def test_pcf_surface_at_rtl_rates_matches_xla(n):
    """Kernel B1's plain version (the PCF surface) at n = 2400 and 3200
    against the JAX package's `caf.caf_accumulate_pcf` on the CPU."""
    fs = n * 1000.0
    rng = np.random.default_rng(n + 1)
    x = (rng.standard_normal((10, n))
         + 1j * rng.standard_normal((10, n))).astype(np.complex64)
    planes = tuple(rng.standard_normal((3, n)).astype(np.float32)
                   for _ in range(2))
    rep = cplx.CArray(jnp.asarray(planes[0]), jnp.asarray(planes[1]))
    want = np.asarray(jcaf.caf_accumulate_pcf(_jb(x), rep, fs))
    got = tcaf.caf_accumulate_pcf(torch.from_numpy(x),
                                  convert.replica_from_jax(planes, "cpu"), fs)
    assert tuple(got.shape) == want.shape
    assert _rel_err(got.numpy(), want) < 1e-4


@pytest.mark.parametrize("batched", [True, False])
def test_caf_surface_matches_jax(batched):
    x, planes, freqs = _case(256, 3, 2, 5, seed=33)
    x = x if batched else x[0]
    rep = cplx.CArray(jnp.asarray(planes[0]), jnp.asarray(planes[1]))
    want = np.asarray(jcaf.caf_surface(_jb(x), rep, jnp.asarray(freqs), FS))
    got = tcaf.caf_surface(torch.from_numpy(x),
                           convert.replica_from_jax(planes, "cpu"), freqs, FS)
    assert tuple(got.shape) == want.shape
    assert _rel_err(got.numpy(), want) < 1e-4


def test_caf_peak_equals_jax():
    rng = np.random.default_rng(34)
    surf = rng.random((3, 4, 16)).astype(np.float32)
    surf[1, 2, 5] = surf[1, 3, 0] = 2.0           # a tie: first flat index
    got = tcaf.caf_peak(torch.from_numpy(surf))
    want = jcaf.caf_peak(jnp.asarray(surf))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (int(got[0][1]), int(got[1][1])) == (2, 5)


def test_phasors_are_cached_and_exact():
    freqs = np.array([-7000.0, 0.0, 3000.0], np.float32)
    a = cuda_caf.phasors(freqs, FS, 2048, torch.device("cpu"))
    assert a is cuda_caf.phasors(list(freqs), FS, 2048, "cpu")
    t = np.arange(2048) / FS
    want = np.exp(-2j * np.pi * freqs.astype(np.float64)[:, None] * t)
    np.testing.assert_allclose(a.numpy(), want, atol=1e-7)


def test_std_search_rejects_other_devices():
    x = torch.zeros(2, 256, dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="device"):
        cuda_caf.caf_accumulate_fused(x, x, [0.0], FS)
    assert cuda_caf.supported(16384) and cuda_caf.supported(3200)
    assert cuda_caf.supported(10368) and cuda_caf.supported(16384 * 2)
    assert cuda_caf.supported(250 * 128) and cuda_caf.supported(131072)
    # a prime factor up to 1021 and n up to 262144 above 16384 (every n
    # the JAX package's v1 takes there), from 128 below
    assert cuda_caf.supported(131 * 128) and cuda_caf.supported(2 * 131072)
    assert cuda_caf.supported(128) and cuda_caf.supported(2 * 128 * 1021)
    assert not cuda_caf.supported(128 * 1031)
    assert not cuda_caf.supported(2 * 128 * 1031)      # above 262144


@pytest.mark.parametrize("channels", [(-3, 4), (-7, 0, 6)])
def test_pcf_fdma_surface_matches_xla(channels):
    """caf_accumulate_pcf_fdma at GLONASS's rate and period (10 MS/s,
    n = 10000), 4 blocks, against the JAX function (XLA, not Pallas)."""
    from gps_jamming_tpu.models.receiver import glonass as jglo
    fs, n = 10e6, 10000
    rng = np.random.default_rng(35)
    x = (rng.standard_normal((4, n))
         + 1j * rng.standard_normal((4, n))).astype(np.complex64)
    rep = jglo.replica_table_host(fs, n)
    offs = jglo.channel_offsets_hz(channels=channels)
    want = np.asarray(jcaf.caf_accumulate_pcf_fdma(_jb(x), rep, offs, fs))
    got = tcaf.caf_accumulate_pcf_fdma(torch.from_numpy(x),
                                       convert.replica_from_jax(rep, "cpu"),
                                       offs, fs)
    assert tuple(got.shape) == want.shape == (len(channels), 90, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * want.max())
