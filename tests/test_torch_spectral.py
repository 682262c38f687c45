"""Port Welch PSD (ops.spectral, ops.cuda_psd plain path) vs the JAX package.

References: the XLA `spectral.welch_psd_p`, the Pallas kernel
`pallas_psd.welch_psd_fused` in interpret mode (as tests/test_pallas_psd.py
runs it), and scipy. Tolerance rtol 1e-4, atol 1e-4 * max: float32 FFTs of
different factorizations summed in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_jamming_tpu.ops import cplx, pallas_psd
from gps_jamming_tpu.ops import spectral as jspec
from gps_jamming_tpu_torch.kernels import build
from gps_jamming_tpu_torch.ops import cuda_psd
from gps_jamming_tpu_torch.ops import spectral as tspec

torch.set_num_threads(2)

FS = 2.048e6
SIZES = [16384, 100_000, 131072]


def _signal(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n)
            + 1j * rng.standard_normal(n)).astype(np.complex64)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * want.max())


@pytest.mark.parametrize("n", SIZES)
def test_welch_matches_xla(n):
    x = _signal(n, seed=n)
    want = np.asarray(jspec.welch_psd_p(cplx.asarray(jnp.asarray(x)), FS,
                                        1024))
    got = tspec.welch_psd(torch.from_numpy(x), FS, 1024).numpy()
    assert got.shape == (1024,) and got.dtype == np.float32
    _close(got, want)


@pytest.mark.parametrize("n", SIZES)
def test_kernel_plain_matches_pallas_interpret(n):
    """Kernel B2's CPU path (its plain version) vs the Pallas kernel."""
    x = _signal(n, seed=n + 1)
    want = np.asarray(pallas_psd.welch_psd_fused(
        cplx.asarray(jnp.asarray(x)), FS, 1024, interpret=True))
    before = build.LAUNCHES["welch_psd"]
    got = cuda_psd.welch_psd_fused(torch.from_numpy(x), FS, 1024).numpy()
    assert build.LAUNCHES["welch_psd"] == before          # no kernel on the CPU
    _close(got, want)


def test_welch_matches_scipy_on_tone():
    from scipy import signal as ss
    n = 1 << 16
    t = np.arange(n) / FS
    rng = np.random.default_rng(8)
    x = (np.exp(2j * np.pi * 200e3 * t)
         + 0.5 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    _, want = ss.welch(x, FS, nperseg=1024, return_onesided=False)
    got = tspec.welch_psd(torch.from_numpy(x), FS, 1024).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4 * want.max())
    assert np.argmax(got) == np.argmax(want) == 100


def test_batched_overlap_and_no_detrend_match_xla():
    """The plain path's other arguments: leading batch dims, 25 % overlap,
    detrend off."""
    x = _signal(4 * 8192, seed=9).reshape(4, 8192)
    want = np.asarray(jspec.welch_psd_p(cplx.asarray(jnp.asarray(x)), FS,
                                        256, overlap_frac=0.25,
                                        detrend=False))
    got = tspec.welch_psd(torch.from_numpy(x), FS, 256, overlap_frac=0.25,
                          detrend=False).numpy()
    assert got.shape == (4, 256)
    _close(got, want)


def test_psd_db_shifted_matches_jax():
    p = np.abs(_signal(1024, seed=10)).astype(np.float32) ** 2
    np.testing.assert_allclose(
        tspec.psd_db_shifted(torch.from_numpy(p)).numpy(),
        np.asarray(jspec.psd_db_shifted(jnp.asarray(p))), rtol=1e-6,
        atol=1e-5)


def test_hann_window_is_the_reference_window():
    np.testing.assert_array_equal(tspec._hann(1024), jspec._hann(1024))
    assert cuda_psd.supported(1024) and cuda_psd.supported(64)
    assert cuda_psd.supported(16384) and cuda_psd.supported(1536)
    assert not cuda_psd.supported(1000) and not cuda_psd.supported(36864)
    assert cuda_psd.supported(32768) and cuda_psd.supported(131072)


@pytest.mark.parametrize("nperseg", [384, 1536])
def test_kernel_plain_matches_pallas_interpret_mixed(nperseg):
    """Kernel B2's CPU path at the TPU kernel's mixed-radix sizes (3*128,
    3*512) vs the Pallas kernel in interpret mode, same tolerance."""
    x = _signal(100_000, seed=nperseg)
    want = np.asarray(pallas_psd.welch_psd_fused(
        cplx.asarray(jnp.asarray(x)), FS, nperseg, interpret=True))
    got = cuda_psd.welch_psd_fused(torch.from_numpy(x), FS, nperseg).numpy()
    assert got.shape == (nperseg,)
    _close(got, want)


def test_kernel_takes_every_size_the_tpu_kernel_takes():
    """Every nperseg up to 16384 that the Pallas kernel takes reaches kernel
    B2 on a CUDA tensor (`cuda_psd.supported`, the gate of
    `spectral.welch_psd`)."""
    tpu = [n for n in range(1, 16385) if pallas_psd.supported(n)]
    assert len(tpu) == 24
    assert all(cuda_psd.supported(n) for n in tpu)
    assert sorted(set(tpu) - {1 << k for k in range(7, 15)}) == \
        list(cuda_psd.MIXED_NPERSEG)


@pytest.mark.parametrize("n", [1024, 4096])
def test_detrend_after_the_fft_by_linearity(n):
    """Kernel B2 detrends after the transform: the periodic Hann window's
    DFT is N/2 at bin 0 and -N/4 at bins 1 and N-1, so with S the segment's
    sum, FFT(w (x - S/N)) = X - S/2 at bin 0 and X + S/4 at bins 1 and N-1,
    and X elsewhere. Checked in float32 through the register FFT's schedule
    (fft_plan.emulate) against the detrend-first spectrum in float64, at a
    DC offset of 30 + 20j over 12 LSB noise, summed over 4 segments: within
    1e-4 of each bin (the float32 cancellation at bins 0, 1, N-1 measures
    about 5e-6)."""
    from gps_jamming_tpu_torch.kernels import fft_plan
    rng = np.random.default_rng(n)
    w = tspec._hann(n)
    got, want = np.zeros(n), np.zeros(n)
    for _ in range(4):
        x = (12.0 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
             + (30 + 20j)).astype(np.complex64)
        s = x.sum(dtype=np.complex64)
        X = fft_plan.emulate((x * w).astype(np.complex64))
        X[0] -= np.complex64(0.5) * s
        X[1] += np.complex64(0.25) * s
        X[-1] += np.complex64(0.25) * s
        got += np.abs(X.astype(np.complex128)) ** 2
        x64 = x.astype(np.complex128)
        want += np.abs(np.fft.fft((x64 - x64.mean()) * w)) ** 2
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
