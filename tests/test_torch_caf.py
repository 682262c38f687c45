"""Port PCF acquisition search (ops.caf, ops.cuda_pcf, ops.corr) vs the JAX
package.

The same seeded blocks and replica go through both. References: the XLA
`caf.caf_accumulate_pcf`, and the Pallas PCF kernel in interpret mode with
f32 operands (`pallas_caf.caf_accumulate_pcf_fused`, as
tests/test_pallas_caf.py runs it) for the surface, stats and peak-only modes.
Surface tolerance rtol 2e-4, atol 2e-4 * max (as test_pallas_caf.py);
stats max and sums rtol 1e-4; the arg-lag is exact on every row (the seed
gives every row a top value clear of the next by > 1e-5 relative).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_jamming_tpu.ops import caf as jcaf
from gps_jamming_tpu.ops import corr as jcorr
from gps_jamming_tpu.ops import cplx, pallas_caf
from gps_jamming_tpu_torch import convert
from gps_jamming_tpu_torch.kernels import build
from gps_jamming_tpu_torch.ops import caf as tcaf
from gps_jamming_tpu_torch.ops import corr as tcorr
from gps_jamming_tpu_torch.ops import cuda_pcf

torch.set_num_threads(2)

FS = 2.048e6


def _case(n, nb, nprn, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((nb, n))
         + 1j * rng.standard_normal((nb, n))).astype(np.complex64)
    re = rng.standard_normal((nprn, n)).astype(np.float32)
    im = rng.standard_normal((nprn, n)).astype(np.float32)
    return x, (re, im)


def _jax_blocks(x):
    return cplx.CArray(jnp.asarray(x.real.copy()), jnp.asarray(x.imag.copy()))


def _surf_close(got, want):
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4 * want.max())


def test_doppler_grids_match_jax():
    for n in (2048, 4096, 16384):
        np.testing.assert_array_equal(tcaf.pcf_doppler_hz(FS, n, 7000.0),
                                      jcaf.pcf_doppler_hz(FS, n, 7000.0))
        for nb in (4, 10):
            assert tcaf.pcf_profitable(n, nb, FS, 7000.0, 71) == \
                jcaf.pcf_profitable(n, nb, FS, 7000.0, 71)
    np.testing.assert_array_equal(tcaf.doppler_bins(7000.0, 200.0),
                                  jcaf.doppler_bins(7000.0, 200.0))


@pytest.mark.parametrize("n,nb,nprn", [(2048, 10, 8), (256, 4, 3)])
def test_pcf_surface_matches_xla(n, nb, nprn):
    """caf_accumulate_pcf on the CPU (kernel B1's plain version) vs the XLA
    reference."""
    x, planes = _case(n, nb, nprn, seed=11)
    want = np.asarray(jcaf.caf_accumulate_pcf(
        _jax_blocks(x), cplx.CArray(jnp.asarray(planes[0]),
                                    jnp.asarray(planes[1])), FS))
    got = tcaf.caf_accumulate_pcf(torch.from_numpy(x),
                                  convert.replica_from_jax(planes, "cpu"), FS)
    assert tuple(got.shape) == want.shape
    _surf_close(got.numpy(), want)


def test_kernel_plain_surface_matches_pallas_interpret():
    """Kernel B1's CPU path (prologue + plain search) vs the Pallas kernel,
    and vs the XLA reference on the same input."""
    x, planes = _case(2048, 10, 8, seed=12)
    jb, jrep = _jax_blocks(x), cplx.CArray(*planes)
    want = np.asarray(pallas_caf.caf_accumulate_pcf_fused(
        jb, jrep, FS, precision="f32", interpret=True))
    xt, rep = torch.from_numpy(x), convert.replica_from_jax(planes, "cpu")
    before = build.LAUNCHES["pcf"]
    got = cuda_pcf.caf_accumulate_pcf_fused(xt, rep, FS)
    assert build.LAUNCHES["pcf"] == before          # no kernel on the CPU
    assert tuple(got.shape) == want.shape == (8, 90, 2048)
    _surf_close(got.numpy(), want)
    _surf_close(got.numpy(), np.asarray(jcaf.caf_accumulate_pcf(
        jb, cplx.CArray(jnp.asarray(planes[0]), jnp.asarray(planes[1])),
        FS)))


def _stats_pair(seed, excl):
    x, planes = _case(2048, 10, 8, seed=seed)
    jb, jrep = _jax_blocks(x), cplx.CArray(*planes)
    surf = np.asarray(pallas_caf.caf_accumulate_pcf_fused(
        jb, jrep, FS, precision="f32", interpret=True))
    want = [np.asarray(s) for s in pallas_caf.caf_accumulate_pcf_fused(
        jb, jrep, FS, precision="f32", interpret=True, stats_excl=excl)]
    got = [s.numpy() for s in cuda_pcf.caf_accumulate_pcf_fused(
        torch.from_numpy(x), convert.replica_from_jax(planes, "cpu"), FS,
        stats_excl=excl)]
    top2 = np.sort(surf, axis=-1)[..., -2:]
    assert ((top2[..., 1] - top2[..., 0]) > 1e-5 * top2[..., 1]).all()
    return got, want


def test_kernel_plain_stats_match_pallas_interpret():
    got, want = _stats_pair(seed=3, excl=4)
    assert all(g.shape == w.shape == (8, 90) for g, w in zip(got, want))
    np.testing.assert_array_equal(got[1], want[1])           # arg-lag
    for i in (0, 2, 3, 4):          # max, excluded max, total, window sum
        np.testing.assert_allclose(got[i], want[i], rtol=1e-4)


def test_kernel_plain_peak_only_matches_pallas_interpret():
    got, want = _stats_pair(seed=4, excl=-1)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    np.testing.assert_array_equal(got[1], want[1])
    for i in (2, 3, 4):
        assert not got[i].any() and not want[i].any()


def test_surface_stats_ties_take_the_lowest_lag():
    surf = torch.zeros(1, 2, 16)
    surf[0, 0, [3, 9]] = 5.0
    surf[0, 1, [15, 0]] = 2.0
    max1, arg, exmax, tot, wsum = cuda_pcf.surface_stats(surf, 1)
    assert arg.tolist() == [[3.0, 0.0]]
    assert exmax.tolist() == [[5.0, 0.0]] and tot.tolist() == [[10.0, 4.0]]
    assert wsum.tolist() == [[5.0, 4.0]]        # lag 15 is next to lag 0


def test_pcf_search_rejects_bad_arguments():
    y = torch.zeros(12, 256, dtype=torch.complex64)
    rep = torch.zeros(2, 256, dtype=torch.complex64)
    with pytest.raises(ValueError):
        cuda_pcf.pcf_search(y, rep, 14, 6, 2)                # even n_c
    with pytest.raises(ValueError):
        cuda_pcf.pcf_search(y, rep, 15, 6, 2, stats_excl=128)
    with pytest.raises(ValueError):
        cuda_pcf.pcf_search(y, rep, 15, 6, 2, stats_excl=-2)
    assert cuda_pcf.supported(2048) and cuda_pcf.supported(16384)
    # mixed-radix lengths (prime factors <= 127) are in; GLONASS's 10000
    # qualifies, though its search stays in plain torch
    assert cuda_pcf.supported(2400) and cuda_pcf.supported(10000)
    assert cuda_pcf.supported(4 * 127) and cuda_pcf.supported(3 ** 8)
    # from 128 (v3's 1 x 128, the register FFT's 128-point schedule)
    assert cuda_pcf.supported(128) and not cuda_pcf.supported(2 * 131)
    assert cuda_pcf.supported(2 * 127) and not cuda_pcf.supported(64)
    # above 16384 the sizes of the TPU's v3, on the four-step FFT
    assert cuda_pcf.supported(32768) and cuda_pcf.supported(20480)
    assert not cuda_pcf.supported(32768 + 128)
    assert not cuda_pcf.supported(65536)


@pytest.mark.parametrize("n_prn", [1, 3, 32, 130])
def test_tpu_gate_copy_matches_jax_dispatch(n_prn):
    """caf.tpu_kernel_takes is the JAX package's Pallas gate: PCF is
    `supported_pcf`, std is `fused_dispatch` is not None, over every n from
    128 to 70000 in steps of 2 and the port's and the reference's sizes."""
    ns = sorted(set(range(128, 70001, 2)) | {2062, 2187, 32768, 65536,
                                             131072, 81 * 128})
    for n in ns:
        assert tcaf.tpu_kernel_takes(n, n_prn, pcf=True) \
            == pallas_caf.supported_pcf(n, n_prn), n
        assert tcaf.tpu_kernel_takes(n, n_prn, pcf=False) \
            == (jcaf.fused_dispatch(n, n_prn) is not None), n
    # 2062 = 2 * 1031: no TPU kernel, no port kernel, so plain on a CUDA
    # tensor; 32768: a TPU kernel takes it, so the port's wrapper decides
    assert not tcaf.tpu_kernel_takes(2062, n_prn, pcf=False)
    assert tcaf.tpu_kernel_takes(32768, 3, pcf=True)
    assert not tcaf.plain_on_card(torch.zeros(2, 2062, dtype=torch.complex64),
                                  n_prn, pcf=True)       # a CPU tensor


def test_corr_reductions_match_jax():
    rng = np.random.default_rng(13)
    rows = rng.random((6, 64)).astype(np.float32)
    peak = np.array([0, 1, 31, 32, 62, 63])
    for w in (0, 2, 5):
        np.testing.assert_array_equal(
            tcorr.second_peak_excluded(torch.from_numpy(rows),
                                       torch.from_numpy(peak), w).numpy(),
            np.asarray(jcorr.second_peak_excluded(jnp.asarray(rows),
                                                  jnp.asarray(peak), w)))
        np.testing.assert_allclose(
            tcorr.mean_excluded(torch.from_numpy(rows),
                                torch.from_numpy(peak), w).numpy(),
            np.asarray(jcorr.mean_excluded(jnp.asarray(rows),
                                           jnp.asarray(peak), w)),
            rtol=1e-6)
