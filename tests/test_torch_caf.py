"""Port PCF acquisition search (ops.caf, ops.cuda_pcf, ops.corr) vs the JAX
package.

The same seeded blocks and replica go through both. References: the XLA
`caf.caf_accumulate_pcf`, and the Pallas PCF kernel in interpret mode with
f32 operands (`pallas_caf.caf_accumulate_pcf_fused`, as
tests/test_pallas_caf.py runs it) for the surface, stats and peak-only modes.
Surface tolerance rtol 2e-4, atol 2e-4 * max (as test_pallas_caf.py);
stats max and sums rtol 1e-4; the arg-lag is exact on every row (the seed
gives every row a top value clear of the next by > 1e-5 relative).

Kernel B1's entry takes the code periods (`cuda_pcf.pcf_search` with the
weights and mixes of `prologue_consts`): its plain version equals
`pcf_prologue` then `pcf_search_reference` exactly in the surface,
statistics and peak-only modes, from (nb, n) periods or a longer 1-D
signal, and its per-PRN peak equals the statistics' max over rows; all
four modes match the Pallas kernel in interpret mode at 2048 (32 PRNs, 10
periods) and at 32768 (2 PRNs, 2 periods, +/-1 kHz), the per-PRN peak
against the max over rows of its peak-only statistics (rtol 1e-4).
"""
import functools

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
    x = torch.zeros(10, 256, dtype=torch.complex64)
    rep = torch.zeros(2, 256, dtype=torch.complex64)
    w, mix = cuda_pcf.prologue_consts(10, 256, FS, 2, (-200.0, 0.0, 200.0),
                                      2, torch.device("cpu"))
    with pytest.raises(ValueError):
        cuda_pcf.pcf_search(x, rep, 14, w, mix)               # even n_c
    with pytest.raises(ValueError):
        cuda_pcf.pcf_search(x, rep, 15, w, mix, stats_excl=128)
    with pytest.raises(ValueError):
        cuda_pcf.pcf_search(x, rep, 15, w, mix, stats_excl=-2)
    with pytest.raises(ValueError, match="peak alone"):
        cuda_pcf.pcf_search(x, rep, 15, w, mix, stats_excl=4, per_prn=True)
    with pytest.raises(ValueError, match="periods"):
        cuda_pcf.pcf_search(x[:8], rep, 15, w, mix)           # 8 periods
    with pytest.raises(ValueError, match="periods"):
        cuda_pcf.pcf_search(x.reshape(-1)[:2559], rep, 15, w, mix)
    with pytest.raises(ValueError, match="divisible"):
        cuda_pcf.prologue_consts(9, 256, FS, 2, (0.0,), 2, torch.device("cpu"))
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


MODES = {"surface": {}, "stats": {"stats_excl": 4},
         "peak": {"stats_excl": -1}, "per_prn": {"per_prn": True}}


def _folded(x, rep, fs, max_doppler_hz, mode):
    """Kernel B1's entry on CPU tensors: the periods x, `mode` of MODES."""
    nb, n = x.shape[-2:] if x.dim() == 2 else (10, rep.shape[-1])
    w, mix = cuda_pcf.prologue_consts(nb, n, fs, 2, (-200.0, 0.0, 200.0), 2,
                                      x.device)
    return cuda_pcf.pcf_search(x, rep, cuda_pcf.n_coarse(fs, n,
                                                         max_doppler_hz),
                               w, mix, **MODES[mode])


@pytest.mark.parametrize("form", ["periods", "signal"])
@pytest.mark.parametrize("mode", list(MODES))
def test_folded_search_plain_equals_prologue_then_search(mode, form):
    """The plain version of B1's entry is `pcf_prologue` then
    `pcf_search_reference`, exactly, from (nb, n) periods or from a 1-D
    signal of more samples whose first nb * n are the periods; its per-PRN
    peak is the statistics' max over rows."""
    x, planes = _case(256, 10, 3, seed=21)
    xt, rep = torch.from_numpy(x), convert.replica_from_jax(planes, "cpu")
    arg = xt if form == "periods" else torch.cat(
        [xt.reshape(-1), torch.ones(300, dtype=torch.complex64)])
    before = build.LAUNCHES["pcf"]
    got = _folded(arg, rep, FS, 7000.0, mode)
    assert build.LAUNCHES["pcf"] == before          # no kernel on the CPU
    n_c = cuda_pcf.n_coarse(FS, 256, 7000.0)
    surf = cuda_pcf.pcf_search_reference(cuda_pcf.pcf_prologue(xt, FS), rep,
                                         n_c, 6, 2)
    if mode == "per_prn":
        stats = cuda_pcf.surface_stats(surf, 4)
        assert got.shape == (3,)
        assert torch.equal(got, stats[0].amax(dim=-1))
        assert torch.equal(got, surf.amax(dim=(-2, -1)))
        return
    excl = MODES[mode].get("stats_excl")
    if excl is None:
        assert torch.equal(got, surf)
        return
    for g, w in zip(got, cuda_pcf.surface_stats(surf, excl), strict=True):
        assert torch.equal(g, w)


# (n, periods, PRNs, sample rate, max Doppler): GPS at 2.048 MS/s, and
# Galileo E1B at 8.192 MS/s above 16384 lags
PALLAS_CASES = {"gps_2048": (2048, 10, 32, FS, 7000.0),
                "e1b_32768": (32768, 2, 2, 8.192e6, 1000.0)}


@functools.lru_cache(maxsize=None)
def _pallas_case(case, excl):
    """The seeded case's periods and replica planes, and the Pallas PCF
    kernel's answer in interpret mode (excl None: the surface)."""
    n, nb, nprn, fs, hz = PALLAS_CASES[case]
    x, planes = _case(n, nb, nprn, seed=n + nb)
    kw = {} if excl is None else {"stats_excl": excl}
    out = pallas_caf.caf_accumulate_pcf_fused(
        _jax_blocks(x), cplx.CArray(*planes), fs, max_doppler_hz=hz,
        precision="f32", interpret=True, **kw)
    want = np.asarray(out) if excl is None else [np.asarray(s) for s in out]
    return x, planes, want


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", list(PALLAS_CASES))
def test_folded_search_matches_pallas_interpret(case, mode):
    """B1's entry, plain, from the periods, against the Pallas PCF kernel;
    the per-PRN peak against the max over rows of its peak-only stats."""
    n, nb, nprn, fs, hz = PALLAS_CASES[case]
    excl = {"surface": None, "stats": 4}.get(mode, -1)
    x, planes, want = _pallas_case(case, excl)
    got = _folded(torch.from_numpy(x), convert.replica_from_jax(planes, "cpu"),
                  fs, hz, mode)
    if mode == "surface":
        assert tuple(got.shape) == want.shape
        _surf_close(got.numpy(), want)
    elif mode == "per_prn":
        assert tuple(got.shape) == (nprn,)
        np.testing.assert_allclose(got.numpy(), want[0].max(axis=-1),
                                   rtol=1e-4)
    else:
        got = [g.numpy() for g in got]
        np.testing.assert_array_equal(got[1], want[1])          # arg-lag
        for i in (0, 2, 3, 4):
            np.testing.assert_allclose(got[i], want[i], rtol=1e-4)


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
