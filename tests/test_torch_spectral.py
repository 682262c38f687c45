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
    before = cuda_psd.LAUNCHES
    got = cuda_psd.welch_psd_fused(torch.from_numpy(x), FS, 1024).numpy()
    assert cuda_psd.LAUNCHES == before          # no kernel on the CPU
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
    assert not cuda_psd.supported(1000) and not cuda_psd.supported(16384)
