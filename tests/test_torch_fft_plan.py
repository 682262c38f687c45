"""The register FFT's pass schedule (kernels/fft_plan.py, the Python twin of
csrc/fft_reg.cuh) run in NumPy.

The CUDA kernel cannot run here, so this is the CPU check of its index
arithmetic: for every power of two from 256 to 16384, the schedule's
Stockham passes (thread-owned butterflies, swizzled exchange slots, the
two-level twiddles and their repeated products) reproduce np.fft.ifft * n
and np.fft.fft within 2e-6 of the row's largest value (float32 sums of up
to 16384 terms), and no exchange and no twiddle read has a shared-memory
bank conflict.
"""
import numpy as np
import pytest
import torch

from gps_jamming_tpu_torch.kernels import build, fft_plan

POW2 = [1 << k for k in range(8, 15)]


def _row(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)


@pytest.mark.parametrize("n", POW2)
@pytest.mark.parametrize("inverse", [True, False])
def test_schedule_matches_numpy_fft(n, inverse):
    x = _row(n, n + inverse)
    got = fft_plan.emulate(x, inverse=inverse)
    want = np.fft.ifft(x.astype(np.complex128)) * n if inverse \
        else np.fft.fft(x.astype(np.complex128))
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("n", POW2)
def test_schedule_shape_and_banks(n):
    p, t = fft_plan.points_per_thread(n), fft_plan.threads(n)
    assert p * t == n and t % 32 == 0 and t <= 1024
    rad = fft_plan.radices(n)
    assert int(np.prod(rad)) == n and all(r == p for r in rad[:-1])
    assert rad[-1] in (2, 4, 8, p)
    assert sorted(fft_plan.swizzle(np.arange(n), p)) == list(range(n))
    assert fft_plan.bank_ways(n) == 1


@pytest.mark.parametrize("n", [256, 2048, 16384, 2400, 3200, 10368])
def test_row_twiddles(n):
    """The two-level table for a power of two (each entry within 1e-7 of
    float64, every exponent's product within 3e-7), the half table for a
    mixed-radix n."""
    tab = build.row_twiddles(n, torch.device("cpu")).numpy()
    if n & (n - 1):
        assert tab.shape == ((n + 1) // 2,)
        return
    assert tab.shape == (n // 64 + 64,)
    e = np.arange(n)
    w = tab[e >> 6].astype(np.complex64) * tab[n // 64 + (e & 63)]
    np.testing.assert_allclose(w, np.exp(-2j * np.pi * e / n), rtol=0,
                               atol=3e-7)
