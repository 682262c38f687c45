"""The register FFT's pass schedules (kernels/fft_plan.py, the Python twin
of csrc/fft_reg.cuh) run in NumPy.

The CUDA kernel cannot run here, so this is the CPU check of its index
arithmetic: for every power of two from 64 to 16384, the schedule's
Stockham passes (thread-owned butterflies, swizzled exchange slots, the
two-level twiddles and their repeated products) reproduce np.fft.ifft * n
and np.fft.fft within 2e-6 of the row's largest value (float32 sums of up
to 16384 terms), and no exchange and no twiddle read has a shared-memory
bank conflict; the same for every mixed-radix size of the table. Also
the shared-memory FFT's twin (`mixed_fft`) at rows of the four-step with a
prime factor above 127 (131, 509, 1021: the direct prime stage), and the
correlate stage's thread-block cluster (`cluster_correlate`): which CTA
owns which column and lag, and its power in natural lag order.
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


@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("inverse", [True, False])
def test_schedule_matches_numpy_fft_welch_sizes(n, inverse):
    """The Welch PSD (B2) also runs the register FFT at 64 (8 x 8) and 128
    (8 x 8 x 2), on groups of 8 and 16 threads."""
    x = _row(n, n + inverse)
    got = fft_plan.emulate(x, inverse=inverse)
    want = np.fft.ifft(x.astype(np.complex128)) * n if inverse \
        else np.fft.fft(x.astype(np.complex128))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * np.abs(want).max())
    assert fft_plan.threads(n) == n // 8


@pytest.mark.parametrize("n", POW2)
def test_schedule_shape_and_banks(n):
    """A power of two keeps its radix-P schedule: P = 8 points per thread
    up to 512, else 16, radix-P passes then the rest, the XOR swizzle by
    the bits above log2 P; whole warps; no bank conflict."""
    p = 8 if n <= 512 else 16
    t, pad, shift, rad = fft_plan.SCHEDULES[n]
    assert t == n // p and fft_plan.points(n) == p
    assert t % 32 == 0 and t <= 1024
    assert int(np.prod(rad)) == n and all(r == p for r in rad[:-1])
    assert rad[-1] in (2, 4, 8, p)
    assert (pad, shift) == (0, p.bit_length() - 1)
    assert sorted(fft_plan.slot(np.arange(n), n)) == list(range(n))
    assert fft_plan.bank_ways(n) == 1


@pytest.mark.parametrize("n", [256, 2048, 16384, 2400, 3200, 10368])
def test_row_twiddles(n):
    """B1's and B3's table at a size of their register FFT: the two-level
    table (ceil(n/64) coarse entries, every exponent's product within 3e-7
    of float64); the half table for any other n."""
    tab = build.row_twiddles(n, torch.device("cpu")).numpy()
    if n not in fft_plan.CORRELATE_SIZES:
        assert tab.shape == ((n + 1) // 2,)
        return
    n_c = -(-n // 64)
    assert tab.shape == (n_c + 64,)
    e = np.arange(n)
    w = tab[e >> 6].astype(np.complex64) * tab[n_c + (e & 63)]
    np.testing.assert_allclose(w, np.exp(-2j * np.pi * e / n), rtol=0,
                               atol=3e-7)


@pytest.mark.parametrize("n", [4 * 127, 3 ** 7, 1536, 14336])
def test_row_twiddles_half_table_off_the_mixed_table(n):
    """An n off B1's and B3's register FFT (a prime factor above 7, 3^7,
    or a size that only B2 runs on the register FFT) keeps the half table
    of the shared-memory FFT; B2's table at its sizes is the two-level
    one."""
    assert n not in fft_plan.CORRELATE_SIZES
    tab = build.row_twiddles(n, torch.device("cpu")).numpy()
    np.testing.assert_allclose(
        tab, np.exp(-2j * np.pi * np.arange((n + 1) // 2) / n), atol=1e-7)
    if n in fft_plan.SCHEDULES:
        np.testing.assert_array_equal(
            build.reg_twiddles(n, torch.device("cpu")).numpy(),
            fft_plan.twiddle_table(n))


MIXED = sorted(n for n in fft_plan.SCHEDULES if n & (n - 1))
# sizes whose best schedule found leaves a 2-way access (PERF.md, section 6)
TWO_WAY = {896, 2400, 2800, 3200, 10368}


@pytest.mark.parametrize("n", MIXED)
@pytest.mark.parametrize("inverse", [True, False])
def test_mixed_schedule_matches_numpy_fft(n, inverse):
    """The register FFT's mixed-radix schedules (csrc/fft_reg.cuh's table,
    read by fft_plan): index maps, two-level twiddles, their repeated
    products and the composite radices' own twiddles, in float32, within
    2e-6 of the row's largest value (measured: at most 1.1e-6)."""
    x = _row(n, n + 2 + inverse)
    got = fft_plan.emulate(x, inverse=inverse)
    want = np.fft.ifft(x.astype(np.complex128)) * n if inverse \
        else np.fft.fft(x.astype(np.complex128))
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("n", MIXED)
def test_mixed_schedule_shape_and_banks(n):
    """Whole warps, radices of the kernel's DFTs whose product is n, an
    even first radix (B2 carries the overlapped half over), at most 24
    points per thread, every exchange slot distinct, and at most one
    access per bank pair per half-warp (two at TWO_WAY)."""
    t, _, _, rad = fft_plan.SCHEDULES[n]
    assert t % 32 == 0 and t <= 1024
    assert int(np.prod(rad)) == n and rad[0] % 2 == 0
    # every radix nests the kernel's DFTs: powers of two up to 16, 3, 5, 7
    for r in rad:
        while r > 16 or (r & (r - 1) and r not in (3, 5, 7)):
            a = fft_plan.split_radix(r)
            assert a in (2, 4, 8, 16, 3, 5, 7)
            r //= a
    assert 8 <= fft_plan.points(n) <= 24
    slots = fft_plan.slot(np.arange(n), n)
    assert len(set(slots.tolist())) == n
    assert fft_plan.bank_ways(n) == (2 if n in TWO_WAY else 1)


def test_mixed_table_covers_the_sizes_the_kernels_take():
    """B1 and B3 instantiate the register FFT at the powers of two from 128
    (128: 16 threads, as B2 runs it) and at GPS's RTL-SDR rates (2400,
    2560, 2800, 3200) and v1's 81*128, and at no other size; the table
    holds those and B2's 16 mixed nperseg, which csrc/welch_psd.cu's gate
    lists exactly."""
    import re
    from gps_jamming_tpu_torch.ops import cuda_psd
    assert sorted(fft_plan.CORRELATE_SIZES) == sorted(
        [128] + POW2 + [2400, 2560, 2800, 3200, 10368])
    assert build.FFT_MIN_N == 128 and fft_plan.threads(128) == 16
    assert set(fft_plan.CORRELATE_SIZES) <= set(fft_plan.SCHEDULES)
    assert set(cuda_psd.MIXED_NPERSEG) <= set(fft_plan.SCHEDULES)
    src = (build.CSRC / "welch_psd.cu").read_text()
    block = src[src.index("#define GJT_WELCH_MIXED(X)"):]
    block = block[:block.index("\n\n")]
    assert tuple(int(v) for v in re.findall(r"X\((\d+)\)", block)) == \
        cuda_psd.MIXED_NPERSEG


@pytest.mark.parametrize("n,prime", [(131 * 64, 131), (509 * 32, 509),
                                     (1021 * 16, 1021), (3 ** 4 * 5 * 32, 5)])
@pytest.mark.parametrize("inverse", [True, False])
def test_mixed_fft_prime_stage_matches_numpy_fft(n, prime, inverse):
    """The shared-memory FFT of a four-step row (csrc/fft_smem.cuh,
    `fft_mixed<INV, true>`): the digit-reversed load, the radix-2 stages,
    then each odd prime's stage, a butterfly up to 127 and above it the
    direct stage (`fft_radix_p_direct`: every slot the sum of its p
    inputs, twiddles from the half table), in float32, within 2e-6 of the
    row's largest value (the direct sums of 1021 terms: at most 1.4e-6)
    of np.fft. The rows are those of 16768 = 131 * 128 (n1 = 2), 130304 =
    256 * 509 (n1 = 8) and 261376 = 256 * 1021 (n1 = 16)."""
    assert fft_plan.mixed_plan(n)[1][-1] == prime
    x = _row(n, n + inverse)
    got = fft_plan.mixed_fft(x, inverse=inverse)
    want = np.fft.ifft(x.astype(np.complex128)) * n if inverse \
        else np.fft.fft(x.astype(np.complex128))
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * np.abs(want).max())
    # the one-block rows take odd primes up to 127 only
    assert fft_plan.mixed_plan(n, build.FFT_MAX_RADIX) is None or prime <= 127


@pytest.mark.parametrize("n", [20480, 24576, 28672, 32768, 32000, 16768,
                               65536, 131072, 130304])
def test_cluster_split_and_lags(n):
    """The cluster of the correlate stage (csrc/pcf_correlate.cuh,
    `pcf_correlate_cluster`): n1 CTAs of n2-point rows; CTA k1 owns the
    columns t2 in [k1*S, k1*S + S), S = n2/n1, and its power slot t1*S + j
    holds lag t1*n2 + k1*S + j: the slots of all CTAs hold every lag
    once, and each CTA's lags ascend in its threads' walk (t1, then j), as
    the lowest-lag tie-break needs. Its power equals np.fft's |ifft(Y *
    rep shifted)|^2 * n^2 within 2e-6 of the largest value, for shifts of
    both signs, from the four-step forward's permuted spectrum."""
    n1, n2 = fft_plan.cluster_split(n)
    assert (n1, n2) == fft_plan.large_split(n) and n1 <= 8
    assert fft_plan.cluster_smem_bytes(n1, n2) <= fft_plan.SMEM_PER_BLOCK
    s = n2 // n1
    lags = fft_plan.cluster_lags(n)
    assert lags.shape == (n1, n2)
    assert sorted(lags.ravel().tolist()) == list(range(n))
    for k1 in range(n1):
        own = lags[k1].reshape(n1, s)             # [t1][j]
        assert (own == np.arange(n1)[:, None] * n2 + k1 * s
                + np.arange(s)[None, :]).all()
        assert (np.diff(lags[k1]) > 0).all()
    x = _row(n, n + 5)
    rep = _row(n, n + 6)
    yp = fft_plan.four_step_forward(x[None])[0]
    spec = np.fft.fft(x.astype(np.complex128))
    for shift in (-3, 0, 7):
        want = np.abs(np.fft.ifft(spec * np.roll(rep, shift)) * n) ** 2
        got = fft_plan.cluster_correlate(yp, rep, shift)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-6 * want.max())


def test_cluster_plan_takes_every_n1_up_to_8():
    """Up to 131072 every n the gates take splits into n1 <= 8 CTAs and
    runs in the cluster (the largest CTA, 16384-point rows at n1 = 8,
    holds 216608 bytes of the 232448 a block may take); above it n1 = 16,
    a cluster that is not portable, so the two passes through scratch."""
    from gps_jamming_tpu_torch.ops import cuda_caf
    assert fft_plan.cluster_smem_bytes(8, 16384) == 216608
    assert fft_plan.cluster_split(160000) is None
    assert fft_plan.large_split(160000) == (16, 10000)
    for n in (20480, 32000, 65536, 98304, 131072):
        assert cuda_caf.supported(n) and fft_plan.cluster_split(n)
