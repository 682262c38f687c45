"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one. The machine with
the card has no JAX, and tests/conftest.py imports it, so run this file
there without the conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: the surface and the PSD rtol 1e-3, atol 1e-4 * max (float32
FFTs of different factorizations, sums in another order; B2's detrend
after the FFT adds at most about 1e-4 of a bin at a DC offset 25 times
the noise; without the detrend the max leaves out bins 0, 1 and N-1,
where a DC offset lands, so that the atol stays at the noise's scale);
stats max and sums rtol 1e-3; the arg-lag exact on rows whose top two
values differ by more than 1e-4 relative. B1 (all three modes) and B3 are
held at every power of two from 128 to 16384 and at the mixed-radix n of
GPS at 2.4, 2.56, 2.8 and 3.2 MS/s (2400, 2560, 2800, 3200) and v1's
81*128 = 10368 (the register FFT of csrc/fft_reg.cuh), and at an odd n
(3^7), one with a generic-radix stage (4*127) and some of B2's mixed
sizes (384, 1536, 12288, 14336), which keep the shared-memory FFT, to the
same tolerances. B2 is also held at a full-scale DC of 127 LSB over 1 LSB
of noise at nperseg 16384, the detrend's worst case. Above 16384 all three
run the four-step FFT (csrc/fft_large.cuh), held to the same tolerances:
B1 at 20480, 24576, 28672 and 32768 (Galileo E1B at 8.192 MS/s) and B3 at
20480, 32768, 32000 (rows of 16000 on the shared-memory FFT), 65536 and
131072, each correlate stage in a thread-block cluster (its plan equal to
`fft_plan.cluster_split`), B3 also at the sizes it took last (16768 = 131
* 128, 130304 = 256 * 509, 160000, 240000 and 261376 = 256 * 1021; n1 =
16 above 131072, on the two passes), B2 at nperseg 20480, 32768, 49152
and 131072; a CUDA Welch at nperseg 65536 never calls torch.fft.

Where neither B1 and B3 nor the JAX package's Pallas kernels take an n
(2062, a prime factor 1031) their callers compute the plain surfaces on the
card without a launch, and acquisition equals the CPU's; PCF at n = 128
(GPS at 128 kS/s) launches B1 once and equals the CPU; where only a TPU
kernel takes n (std above 262144, 263936 = 2 * 128 * 1031) the card
raises, with no launch. The localization ops
and the batch product path (`pipeline.analyze_capture(streaming=False)`)
on the card equal the CPU on a seeded 1 s 3-antenna jammed set. B2 also
runs over (rows, n), one launch per row, each row the plain version's,
as the spectrogram sends its chunks; the simulator on the card equals the
CPU in its deterministic parts; the dashboard starts, stops and restarts
an analysis on the card. The
streaming receiver's wire unpacks equal the CPU's for every byte; on a
4.5 s jammed GPS capture it gives the CPU's spans, B1 once per
acquisition attempt, the tracker within phase 5b's limits, and a killed
and resumed run equals the uninterrupted one bitwise; its window upload
overlaps running compute and is read only after its event. The sharded
path on a mesh of one repeated card launches B1 or B3 once per shard and
B2 once per time shard, and equals the single-device calls (rtol 2e-4,
atol 1e-3 * max for the surfaces) and the CPU mesh; on two distinct
cards, where the machine has them, it equals the repeated card bitwise;
three files on one card upload their raw bytes, 2 B a sample, from
page-locked rows (one `Pinned` HtoD record each), and two passes in a row
over two different sets equal the CPU mesh and, bitwise, the card's
answers from pageable rows.
"""
import numpy as np
import pytest
import torch

from gps_jamming_tpu_torch.kernels import build
from gps_jamming_tpu_torch.ops import cuda_caf, cuda_pcf, cuda_psd, spectral

FS = 2.048e6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _cplx(shape, seed, dev):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return torch.from_numpy(x.astype(np.complex64)).to(dev)


def _assert_close(got, ref, rtol, atol):
    err = (got.double() - ref.double()).abs()
    bad = err > atol + rtol * ref.double().abs()
    assert not bool(bad.any()), f"max abs err {float(err.max()):.3e}"


# Kernel B2 at every nperseg it takes (the powers of two from 64 to 16384
# and the TPU kernel's 16 mixed-radix sizes), over about 9 segments and a
# small DC offset, plus the main path's 512k-sample block, a ragged tail,
# and a DC offset of 30 + 20j: 25 times the noise, where the detrend after
# the FFT (X[k] - m W[k] at bins 0, 1 and N-1) cancels the most. Without
# the detrend the DC lands in bins 0, 1 and N-1 (the Hann window's three
# DFT bins), so the atol's max leaves them out.
WELCH_CASES = (
    [(1 << k, (9 << k) // 2 + 77, 0.3 - 0.2j) for k in range(6, 15)]
    + [(m, 9 * m // 2 + 77, 0.3 - 0.2j) for m in cuda_psd.MIXED_NPERSEG]
    + [(1024, 1 << 19, 0.3 - 0.2j), (1024, 100_000, 0.3 - 0.2j),
       (1024, 1 << 19, 30 + 20j), (64, 5000, 30 + 20j),
       (1536, 100_000, 30 + 20j), (16384, 300_000, 30 + 20j),
       # a full-scale RTL-SDR DC (127 LSB) over 1 LSB of noise at the
       # largest nperseg: the worst case of the detrend after the FFT
       (16384, 300_000, 127 + 0j),
       # above 16384: the four-step FFT, the mean subtracted before it
       (20480, 9 * 20480 // 2 + 77, 0.3 - 0.2j),
       (32768, 9 * 32768 // 2 + 77, 0.3 - 0.2j),
       (49152, 9 * 49152 // 2 + 77, 30 + 20j),
       (131072, 300_000, 127 + 0j)])


@pytest.mark.parametrize("nperseg,n,dc", WELCH_CASES)
@pytest.mark.parametrize("detrend", [True, False])
def test_welch_kernel_matches_plain(dev, nperseg, n, dc, detrend):
    x = _cplx(n, seed=n, dev=dev) + dc
    before = build.LAUNCHES["welch_psd"]
    got = cuda_psd.welch_psd_fused(x, FS, nperseg, detrend)
    torch.cuda.synchronize()
    assert build.LAUNCHES["welch_psd"] == before + 1
    ref = cuda_psd.welch_psd_reference(x, FS, nperseg, detrend)
    scale = ref if detrend else ref[2:-1]
    _assert_close(got, ref, 1e-3, 1e-4 * float(scale.max()))


@pytest.mark.parametrize("nperseg", [64, 1024, 1536, 16384, 32768, 131072])
def test_welch_kernel_is_bitwise_repeatable(dev, nperseg):
    """Fixed tiles and a fixed sum order, no float atomics: two calls give
    the same bits, also with another size's call between them (the slice
    tickets reset themselves)."""
    x = _cplx(1 << 19, seed=nperseg, dev=dev) + (3 - 2j)
    a = cuda_psd.welch_psd_fused(x, FS, nperseg)
    cuda_psd.welch_psd_fused(x, FS, 256)
    b = cuda_psd.welch_psd_fused(x, FS, nperseg)
    assert torch.equal(a, b)


def test_welch_dispatch_on_cuda(dev):
    """welch_psd takes the kernel on a CUDA tensor where its gate holds
    (a power of two or a mixed-radix nperseg), and the kernel wrapper
    raises (never falls back) where it does not."""
    x = _cplx(1 << 15, seed=1, dev=dev)
    before = build.LAUNCHES["welch_psd"]
    spectral.welch_psd(x, FS, 1024)
    assert build.LAUNCHES["welch_psd"] == before + 1
    spectral.welch_psd(x, FS, 1536)
    assert build.LAUNCHES["welch_psd"] == before + 2
    spectral.welch_psd(x, FS, 1024, overlap_frac=0.25)   # plain path
    assert build.LAUNCHES["welch_psd"] == before + 2
    for bad in (1000, 36864, 2400):
        with pytest.raises(ValueError):
            cuda_psd.welch_psd_fused(_cplx(1 << 16, seed=2, dev=dev), FS, bad)
    with pytest.raises(ValueError):
        cuda_psd.welch_psd_fused(x[::2], FS, 1024)        # not contiguous
    assert build.LAUNCHES["welch_psd"] == before + 2


# Kernel F1, the monitor step's block front, against its plain version on
# the card: the main path's 512k samples and entry()'s 128k in chunks of
# 32768, a partial last chunk, and 8000 chunks of 64 samples ending in a
# ragged 3 samples (near the most, build.FRONT_MAX_CHUNKS = 8192). x is
# bitwise; pm rtol 1e-6: F1 rounds
# each chunk's exact integer sum once, torch's float32 reduction at every
# add (tests/test_torch_front.py holds torch's within 1e-6 of the exact
# mean); the baseline and the threshold are torch.quantile's and the
# plain product's on F1's own pm, bitwise; the flags equal.
FRONT_CASES = [(1 << 19, 32768), (1 << 17, 32768), ((1 << 19) + 1000, 32768),
               (8000 * 64 - 5, 64)]


def _front_raw(n, seed, dev, offset=0):
    """(2n,) int8 noise with a strong tone over the second tenth, as a
    view `offset` bytes into its buffer."""
    rng = np.random.default_rng(seed)
    v = rng.normal(0.0, 6.0, 2 * n + offset)
    lo, hi = offset + 2 * (n // 10), offset + 2 * (n // 5)
    v[lo:hi] += 60.0
    buf = torch.from_numpy(np.clip(np.round(v), -128, 127).astype(np.int8))
    return buf.to(dev)[offset:]


@pytest.mark.parametrize("n,chunk", FRONT_CASES)
def test_front_kernel_matches_plain(dev, n, chunk):
    from gps_jamming_tpu_torch.ops import cuda_front
    raw = _front_raw(n, n % 1009, dev)
    before = build.LAUNCHES["front"]
    x, pm, flags = cuda_front.block_front(raw, chunk, 5.0, 6.0)
    base, thr = cuda_front.last_threshold(dev)
    assert cuda_front.last_threshold("cuda") == (base, thr)
    assert build.LAUNCHES["front"] == before + 1
    rx, rpm, rflags = cuda_front.block_front_reference(raw, chunk, 5.0, 6.0)
    assert torch.equal(x, rx)
    _assert_close(pm, rpm, 1e-6, 0.0)
    want_base = torch.quantile(pm, 0.05)
    want_thr = want_base * 10.0 ** 0.6
    assert base == float(want_base) and thr == float(want_thr)
    assert torch.equal(flags, pm > want_thr) and torch.equal(flags, rflags)
    assert bool(flags.any()) and not bool(flags.all())
    again = cuda_front.block_front(raw, chunk, 5.0, 6.0)
    assert all(torch.equal(a, b) for a, b in zip((x, pm, flags), again))


def test_front_kernel_raises_above_its_chunks(dev):
    from gps_jamming_tpu_torch.ops import cuda_front
    raw = torch.zeros(2 * (build.FRONT_MAX_CHUNKS * 64 + 1), dtype=torch.int8,
                      device=dev)
    before = build.LAUNCHES["front"]
    with pytest.raises(ValueError, match="chunks"):
        cuda_front.block_front(raw, 64, 5.0, 6.0)
    with pytest.raises(ValueError):
        cuda_front.block_front(raw[:-1], 64, 5.0, 6.0)      # odd byte count
    with pytest.raises(ValueError):
        cuda_front.block_front(raw[::2], 64, 5.0, 6.0)      # not contiguous
    assert build.LAUNCHES["front"] == before
    # the scratch is left as a call needs it: the next call is right
    small = _front_raw(1 << 17, 5, dev)
    got = cuda_front.block_front(small, 32768, 5.0, 6.0)
    want = cuda_front.block_front_reference(small, 32768, 5.0, 6.0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])


@pytest.mark.parametrize("n,chunk,offset", [(100_003, 3001, 0),
                                             ((1 << 19) + 1000, 32768, 2)])
def test_front_kernel_raises_off_its_layout(dev, n, chunk, offset):
    """F1 takes chunks of a multiple of 8 samples and 16-byte aligned
    bytes (the main path's 32768-sample chunks of whole blocks): another
    chunk or a view off that alignment raises, with no launch."""
    from gps_jamming_tpu_torch.ops import cuda_front
    raw = _front_raw(n, n % 1009, dev, offset)
    before = build.LAUNCHES["front"]
    with pytest.raises(ValueError, match="16-byte"):
        cuda_front.block_front(raw, chunk, 5.0, 6.0)
    assert build.LAUNCHES["front"] == before


@pytest.mark.parametrize("method", ["pcf", "std"])
def test_monitor_step_front_is_one_launch(dev, monkeypatch, method):
    """On CUDA tensors the monitor step (both methods) and entry()'s forward
    take their front from F1, one launch a call, with no torch.quantile
    and no plain chunk power on the path; the outputs match the CPU's."""
    from gps_jamming_tpu_torch import entry
    from gps_jamming_tpu_torch.ops import codes, cuda_front, power
    raw = _front_raw(1 << 19, 11, dev)
    replica = codes.gps_replica_table(entry.FS, entry.N_CODE, dev)
    cpu = entry.detect_acquire_step(raw.cpu(), method=method)

    def forbidden(*args, **kwargs):
        raise AssertionError("plain front on the card")

    monkeypatch.setattr(torch, "quantile", forbidden)
    monkeypatch.setattr(power, "chunk_power", forbidden)
    before = build.LAUNCHES["front"]
    got = entry.detect_acquire_step(raw, replica, method=method)
    assert build.LAUNCHES["front"] == before + 1
    fwd, (raw_ex,) = entry.entry(dev)
    fwd(raw_ex)
    assert build.LAUNCHES["front"] == before + 2
    monkeypatch.undo()
    _assert_close(got[1].cpu(), cpu[1], 1e-6, 0.0)
    assert torch.equal(got[2].cpu(), cpu[2])


def _folded_args(blocks, rep, fs=FS, n_c=None):
    """B1's entry arguments for the periods `blocks` (two groups, the
    default sets and fine bins): (blocks, rep, n_c, w, mix)."""
    nb, n = blocks.shape
    w, mix = cuda_pcf.prologue_consts(nb, n, fs, 2, (-200.0, 0.0, 200.0), 2,
                                      blocks.device)
    if n_c is None:
        n_c = cuda_pcf.n_coarse(fs, n, 7000.0)
    return blocks, rep, n_c, w, mix


@pytest.mark.parametrize("n,nb,nprn", [(2048, 10, 32), (256, 4, 5),
                                       (16384, 4, 3), (2400, 10, 32),
                                       (3200, 10, 32), (10368, 4, 3),
                                       (3 ** 7, 4, 5), (4 * 127, 4, 5),
                                       (512, 4, 5), (1024, 4, 5),
                                       (4096, 4, 4), (8192, 4, 3),
                                       (2560, 10, 32), (2800, 10, 32),
                                       (1536, 4, 5), (14336, 4, 3),
                                       (20480, 4, 3), (32768, 4, 3),
                                       (128, 10, 32), (24576, 4, 3),
                                       (28672, 4, 3), (2048, 20, 4),
                                       (3 ** 7, 18, 3), (32768, 18, 2)])
def test_pcf_kernel_matches_plain(dev, n, nb, nprn):
    """B1 from the code periods (its forward builds the prologue's rows as
    it loads them) against the plain search of the prologue's rows, in the
    surface, statistics, peak-only and per-PRN modes, at up to 8 periods a
    group (straight-line loads) and above (in chunks: 2048, 3^7 and 32768
    at 9 and 10); the per-PRN peak is the kernel's own statistics' max over
    rows, bitwise, and the same from a longer 1-D signal whose first nb * n
    samples are the periods."""
    blocks = _cplx((nb, n), seed=n, dev=dev)
    rep = _cplx((nprn, n), seed=n + 1, dev=dev)
    args = _folded_args(blocks, rep)
    ref = cuda_pcf.pcf_search_reference(cuda_pcf.fold(blocks, *args[3:]),
                                        rep, args[2], 6, 2)
    before = build.LAUNCHES["pcf"]
    surf = cuda_pcf.pcf_search(*args)
    torch.cuda.synchronize()
    assert build.LAUNCHES["pcf"] == before + 1
    _assert_close(surf, ref, 1e-3, 1e-4 * float(ref.max()))
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 1e-4 * top2[..., 0]
    for excl in (4, -1):
        got = cuda_pcf.pcf_search(*args, stats_excl=excl)
        want = cuda_pcf.surface_stats(ref, excl)
        same = got[1] == want[1]
        assert bool(same[clear].all())
        _assert_close(got[0], want[0], 1e-3, 0.0)
        _assert_close(got[3], want[3], 1e-3, 0.0)
        _assert_close(got[2][same], want[2][same], 1e-3, 0.0)
        _assert_close(got[4][same], want[4][same], 1e-3, 0.0)
    peak = cuda_pcf.pcf_search(*args, per_prn=True)
    assert peak.shape == (nprn,)
    _assert_close(peak, ref.amax(dim=(-2, -1)), 1e-3, 0.0)
    assert torch.equal(peak, got[0].amax(dim=-1))
    signal = torch.cat([blocks.reshape(-1), _cplx(777, seed=n + 2, dev=dev)])
    assert torch.equal(cuda_pcf.pcf_search(signal, *args[1:], per_prn=True),
                       peak)
    assert build.LAUNCHES["pcf"] == before + 5


@pytest.mark.parametrize("n", [256, 2048, 16384, 2400, 32768, 128, 20480])
def test_pcf_stats_ties_take_the_lowest_lag(dev, n):
    """Rows whose surface is flat (a zero replica row: every lag ties at
    exactly 0) report the lowest lag, 0, as kernel B1's contract says;
    rows with a signal beside them keep their own peak."""
    blocks = _cplx((4, n), seed=n + 7, dev=dev)
    rep = _cplx((4, n), seed=n + 8, dev=dev)
    rep[1] = 0
    rep[3] = 0
    args = _folded_args(blocks, rep, n_c=3)
    ref = cuda_pcf.pcf_search_reference(cuda_pcf.pcf_prologue(blocks, FS),
                                        rep, 3, 6, 2)
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 1e-4 * top2[..., 0]
    assert not bool(clear[[1, 3]].any()) and bool(clear[[0, 2]].all())
    for excl in (4, -1):
        got = cuda_pcf.pcf_search(*args, stats_excl=excl)
        want = cuda_pcf.surface_stats(ref, excl)
        assert bool((got[1][[1, 3]] == 0).all())
        assert bool((want[1][[1, 3]] == 0).all())
        assert bool((got[0][[1, 3]] == 0).all())
        assert torch.equal(got[1][clear], want[1][clear])


def test_pcf_dispatch_on_cuda(dev):
    """caf_accumulate_pcf on a CUDA tensor is kernel B1 for the n it takes;
    for an n it does not take (2062 = 2 * 1031) it computes the plain
    surface on the card without a launch, as the JAX package computes its
    XLA surface there; the kernel's wrapper itself raises for that n."""
    from gps_jamming_tpu_torch.ops import caf
    blocks = _cplx((10, 2048), seed=3, dev=dev)
    rep = _cplx((4, 2048), seed=4, dev=dev)
    before = build.LAUNCHES["pcf"]
    surf = caf.caf_accumulate_pcf(blocks, rep, FS)
    assert build.LAUNCHES["pcf"] == before + 1
    plain = caf.caf_accumulate_pcf(blocks.cpu(), rep.cpu(), FS)
    _assert_close(surf.cpu(), plain, 1e-3, 1e-4 * float(plain.max()))
    b62, r62 = _cplx((10, 2062), seed=5, dev=dev), _cplx((4, 2062), seed=6,
                                                         dev=dev)
    surf = caf.caf_accumulate_pcf(b62, r62, 2.062e6)
    assert surf.is_cuda and build.LAUNCHES["pcf"] == before + 1
    plain = caf.caf_accumulate_pcf(b62.cpu(), r62.cpu(), 2.062e6)
    _assert_close(surf.cpu(), plain, 1e-3, 1e-4 * float(plain.max()))
    with pytest.raises(ValueError, match="prime factor"):
        cuda_pcf.caf_accumulate_pcf_fused(b62, r62, 2.062e6)
    assert build.LAUNCHES["pcf"] == before + 1


@pytest.mark.parametrize("n,nb,nprn,nf,fs", [
    (256, 3, 5, 7, FS), (2048, 10, 32, 71, FS), (8192, 4, 6, 71, 4.096e6),
    (16384, 10, 4, 71, 4.096e6), (2400, 10, 32, 71, 2.4e6),
    (3200, 10, 32, 71, 3.2e6), (10368, 4, 4, 71, 10.368e6),
    (3 ** 7, 3, 5, 7, FS), (4 * 127, 3, 5, 7, FS), (512, 3, 5, 7, FS),
    (1024, 4, 5, 15, FS), (4096, 4, 4, 15, 4.096e6),
    (2560, 10, 32, 71, 2.56e6), (2800, 10, 32, 71, 2.8e6),
    (384, 3, 5, 7, FS), (12288, 4, 3, 15, 12.288e6),
    (32768, 4, 3, 15, 8.192e6), (32000, 4, 3, 15, 8e6),
    (65536, 2, 2, 7, 16.384e6), (131072, 2, 2, 7, 32.768e6),
    (128, 10, 8, 15, 128e3), (20480, 4, 3, 15, 5.12e6),
    (16768, 4, 3, 15, 4.192e6), (130304, 2, 2, 7, 32.576e6),
    (160000, 2, 2, 7, 40e6), (240000, 2, 2, 7, 60e6),
    (261376, 2, 2, 7, 65.344e6)])
def test_caf_std_kernel_matches_plain(dev, n, nb, nprn, nf, fs):
    """Kernel B3 against its plain version: the GPS shape, Galileo E1B's
    16384 lags (one 1024-thread block per SM), every power of two between
    and 128, the mixed-radix n (GPS at 2.4 and 3.2 MS/s, 81*128, 3^7,
    4*127) and the four-step FFT's 20480, 32768, 32000, 65536 and 131072
    (the correlate stage in a cluster), and the sizes with a prime above
    127 (16768 = 131 * 128; 130304 = 256 * 509) or above 131072 (n1 = 16:
    160000, 240000, 261376 = 256 * 1021)."""
    from gps_jamming_tpu_torch.ops import caf
    blocks = _cplx((nb, n), seed=n + 2, dev=dev)
    rep = _cplx((nprn, n), seed=n + 3, dev=dev)
    freqs = caf.doppler_bins(7000.0, 200.0)[:nf]
    ref = cuda_caf.caf_accumulate_reference(blocks, rep, freqs, fs)
    before = build.LAUNCHES["caf_std"]
    got = cuda_caf.caf_accumulate_fused(blocks, rep, freqs, fs)
    torch.cuda.synchronize()
    assert build.LAUNCHES["caf_std"] == before + 1
    assert got.shape == ref.shape == (nprn, nf, n)
    _assert_close(got, ref, 1e-3, 1e-4 * float(ref.max()))
    top2 = ref.topk(2, dim=-1)
    clear = (top2.values[..., 0] - top2.values[..., 1]) \
        > 1e-4 * top2.values[..., 0]
    assert bool((got.argmax(dim=-1) == top2.indices[..., 0])[clear].all())


def test_caf_std_dispatch_on_cuda(dev):
    """caf_accumulate, acquire_all(method='std') and
    detect_acquire_step(method='std') on CUDA tensors each launch kernel B3
    once, as does caf_accumulate at the mixed-radix n = 3200 (3.2 MS/s);
    at an n the kernel does not take (2062) caf_accumulate computes the
    plain surface on the card without a launch, and the kernel's wrapper
    raises."""
    from gps_jamming_tpu_torch.config import AcquisitionConfig
    from gps_jamming_tpu_torch import entry
    from gps_jamming_tpu_torch.models.receiver import acquisition as acq
    from gps_jamming_tpu_torch.ops import caf
    blocks = _cplx((10, 2048), seed=7, dev=dev)
    rep = _cplx((4, 2048), seed=8, dev=dev)
    freqs = caf.doppler_bins(7000.0, 200.0)
    before = build.LAUNCHES["caf_std"]
    surf = caf.caf_accumulate(blocks, rep, freqs, FS)
    assert build.LAUNCHES["caf_std"] == before + 1
    plain = caf.caf_accumulate(blocks.cpu(), rep.cpu(), freqs, FS)
    _assert_close(surf.cpu(), plain, 1e-3, 1e-4 * float(plain.max()))
    acq.acquire_all(blocks, rep, FS, AcquisitionConfig(), method="std")
    assert build.LAUNCHES["caf_std"] == before + 2
    raw = torch.randint(-128, 128, (2 * 65536,), dtype=torch.int8,
                        device=dev)
    entry.detect_acquire_step(raw, method="std")
    assert build.LAUNCHES["caf_std"] == before + 3
    b32, r32 = (_cplx((10, 3200), seed=9, dev=dev),
                _cplx((4, 3200), seed=10, dev=dev))
    surf = caf.caf_accumulate(b32, r32, freqs, 3.2e6)
    assert build.LAUNCHES["caf_std"] == before + 4
    plain = caf.caf_accumulate(b32.cpu(), r32.cpu(), freqs, 3.2e6)
    _assert_close(surf.cpu(), plain, 1e-3, 1e-4 * float(plain.max()))
    b62, r62 = _cplx((10, 2062), seed=9, dev=dev), _cplx((4, 2062), seed=10,
                                                         dev=dev)
    surf = caf.caf_accumulate(b62, r62, freqs, 2.062e6)
    assert surf.is_cuda and build.LAUNCHES["caf_std"] == before + 4
    plain = caf.caf_accumulate(b62.cpu(), r62.cpu(), freqs, 2.062e6)
    _assert_close(surf.cpu(), plain, 1e-3, 1e-4 * float(plain.max()))
    with pytest.raises(ValueError, match="B3"):
        cuda_caf.caf_accumulate_fused(b62, r62, freqs, 2.062e6)
    assert build.LAUNCHES["caf_std"] == before + 4


def test_monitor_step_spans_on_cuda(dev, tmp_path):
    """One monitor step on the card inside `torch_trace`: one
    `gjt.b2.launch` inside `gjt.step.psd` and one `gjt.b1.launch` inside
    `gjt.step.acquire`, each kernel's device records launched from within
    its launch span, and no launch of the step lost (`torch_trace` raises
    on one; the trace is read again here). A device record is tied to its
    launch call by the profiler's correlation id, not by its time: in a
    trace the device clock may lie up to 1.7 ms before the host's (on an
    H100, in 9 of 60 traces), so a kernel can seem to start before it was
    launched."""
    import json

    from gps_jamming_tpu_torch import entry
    from gps_jamming_tpu_torch.ops import codes
    from gps_jamming_tpu_torch.runtime import profiling
    raw = torch.randint(-128, 128, (2 * (1 << 19),), dtype=torch.int8,
                        device=dev)
    replica = codes.gps_replica_table(entry.FS, entry.N_CODE, dev)
    entry.detect_acquire_step(raw, replica)
    torch.cuda.synchronize(dev)
    with profiling.torch_trace(str(tmp_path), dev):
        out = entry.detect_acquire_step(raw, replica)
        torch.cuda.synchronize(dev)
    assert out[3].shape == (32,)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert profiling.lost_launches(events)[1] == []

    def host(name):
        return [(e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("name") == name
                and e.get("cat") == "user_annotation"]

    def within(inner, outer):
        return outer[0] <= inner[0] and inner[1] <= outer[1]

    (psd,), (acquire,) = host("gjt.step.psd"), host("gjt.step.acquire")
    (b2,), (b1,) = host("gjt.b2.launch"), host("gjt.b1.launch")
    assert within(b2, psd) and within(b1, acquire)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    b2_k = [e for e in kernels if "welch_" in e["name"]]
    b1_k = [e for e in kernels if any(
        k in e["name"] for k in ("pcf_forward_kernel", "reg_forward_kernel",
                                 "pcf_correlate"))]
    assert b2_k and b1_k
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}

    def launched_within(k, span):
        return span[0] <= launched[k["args"]["correlation"]] <= span[1]

    assert all(launched_within(e, b2) for e in b2_k)
    assert all(launched_within(e, b1) for e in b1_k)


def _step_trace(step, dev, tmp_path):
    """(launch counts a step made, the names of its kernels' device
    records): one warm call, then one inside `torch_trace`."""
    import json

    from gps_jamming_tpu_torch.runtime import profiling
    step()
    torch.cuda.synchronize(dev)
    before = build.launch_counts()
    with profiling.torch_trace(str(tmp_path), dev):
        out = step()
        torch.cuda.synchronize(dev)
    after = build.launch_counts()
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "kernel"]
    return out, {k: after[k] - before[k] for k in after}, names


def test_galileo_monitor_step_on_cuda(dev, monkeypatch, tmp_path):
    """The monitor step on its Galileo E1B plan (8.192 MS/s, 32768 lags, 36
    PRNs) over a 2M-sample block launches F1, B2 and B1 once each, B1 as
    `gjt_pcf_large` (its four-step forward and one cluster correlate
    record), with torch.fft patched to raise (no plain torch in a
    kernel's place); its outputs equal the CPU's plain version (PSD rtol
    1e-3, atol 1e-4 * max; pm rtol 1e-6; flags equal; peaks rtol 2e-4),
    the CPU run in pieces of 4 PRNs."""
    from gps_jamming_tpu_torch import entry
    plan = entry.GALILEO_E1B_8M192
    raw = _front_raw(1 << 21, 23, dev)
    replica = entry.replica_table(plan, dev)

    def forbidden(*args, **kwargs):
        raise AssertionError("torch.fft on the card")

    def step():
        return entry.detect_acquire_step(raw, replica, plan=plan)

    monkeypatch.setattr(torch.fft, "fft", forbidden)
    monkeypatch.setattr(torch.fft, "ifft", forbidden)
    got, counts, names = _step_trace(step, dev, tmp_path)
    monkeypatch.undo()
    assert counts == {"welch_psd": 1, "pcf": 1, "caf_std": 0, "front": 1}
    assert sum("pcf_correlate_cluster" in k for k in names) == 1
    assert any("large_cols_fwd" in k for k in names)
    assert not any("pcf_forward_kernel" in k or "reg_forward_kernel" in k
                   for k in names)
    assert got[3].shape == (36,)
    raw_c, rep_c = raw.cpu(), replica.cpu()
    want = [entry.detect_acquire_step(raw_c, rep_c[i:i + 4], plan=plan)
            for i in range(0, 36, 4)]
    psd, pm, flags = want[0][:3]
    _assert_close(got[0].cpu(), psd, 1e-3, 1e-4 * float(psd.max()))
    _assert_close(got[1].cpu(), pm, 1e-6, 0.0)
    assert torch.equal(got[2].cpu(), flags)
    _assert_close(got[3].cpu(), torch.cat([w[3] for w in want]), 2e-4, 0.0)


def test_gps_monitor_step_launches_are_unchanged(dev, tmp_path):
    """The GPS plan (the default) keeps its launches: F1, B2 and B1 once
    each a block, B1 below 16384 (no four-step or cluster record), the
    same as the step given no plan."""
    from gps_jamming_tpu_torch import entry
    from gps_jamming_tpu_torch.ops import codes
    raw = _front_raw(1 << 19, 29, dev)
    replica = codes.gps_replica_table(entry.FS, entry.N_CODE, dev)
    counts = []
    for kw in ({}, {"plan": entry.GPS}):
        out, c, names = _step_trace(
            lambda: entry.detect_acquire_step(raw, replica, **kw), dev,
            tmp_path)
        counts.append(c)
        assert out[3].shape == (32,)
        assert not any("large_cols_fwd" in k or "pcf_correlate_cluster" in k
                       for k in names)
    assert counts[0] == counts[1] == {"welch_psd": 1, "pcf": 1,
                                      "caf_std": 0, "front": 1}


@pytest.mark.parametrize("system", ["gps", "galileo"])
def test_monitor_step_acquire_is_b1_alone(dev, tmp_path, system):
    """Inside `gjt.step.acquire` the PCF monitor step makes one call, B1's
    wrapper: no PyTorch operator runs there outside its `gjt.b1.launch`
    span, and every device record launched there is B1's own (its forward,
    whose name carries the folded source `SrcFold`, once; the four-step's
    row pass; the correlate; the memset of the per-PRN peaks): no GEMM, no
    elementwise kernel, no reduce. The (P,) peaks equal the CPU's plain
    version (rtol 2e-4), the CPU run in pieces of 4 PRNs."""
    import json

    from gps_jamming_tpu_torch import entry
    from gps_jamming_tpu_torch.runtime import profiling
    plan = entry.GPS if system == "gps" else entry.GALILEO_E1B_8M192
    raw = _front_raw(1 << (19 if system == "gps" else 21), 31, dev)
    replica = entry.replica_table(plan, dev)
    entry.detect_acquire_step(raw, replica, plan=plan)
    torch.cuda.synchronize(dev)
    with profiling.torch_trace(str(tmp_path), dev):
        got = entry.detect_acquire_step(raw, replica, plan=plan)
        torch.cuda.synchronize(dev)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]

    def span(name):
        (sp,) = [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("name") == name
                 and e.get("cat") == "user_annotation"]
        return sp

    def inside(ts, sp):
        return sp[0] <= ts <= sp[1]

    acquire, b1 = span("gjt.step.acquire"), span("gjt.b1.launch")
    ops = [e["name"] for e in events if e.get("cat") == "cpu_op"
           and inside(e["ts"], acquire) and not inside(e["ts"], b1)]
    assert ops == []
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    records = [(e["cat"], e["name"]) for e in events
               if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy")
               and inside(launched.get(e["args"].get("correlation"), -1.0),
                          acquire)]
    b1_kernels = ("SrcFold", "large_rows_", "pcf_correlate")
    assert records and all(
        cat == "gpu_memset" or (cat == "kernel" and any(
            k in name for k in b1_kernels)) for cat, name in records), records
    assert sum("SrcFold" in name for _, name in records) == 1
    assert got[3].shape == (len(plan.prns),)
    raw_c, rep_c = raw.cpu(), replica.cpu()
    want = torch.cat([entry.detect_acquire_step(raw_c, rep_c[i:i + 4],
                                                plan=plan)[3]
                      for i in range(0, len(plan.prns), 4)])
    _assert_close(got[3].cpu(), want, 2e-4, 0.0)


def _c1_blocks(system, dev):
    """10 code periods of unit noise plus one PRN at -18 dB per sample, at
    an n kernels B1 and B3 do not take: Galileo E1B at 4.192 MS/s (n =
    16768 = 131 * 128; 3 PRNs, +/-2 kHz), GPS at 2.062 MS/s (n = 2062 =
    2 * 1031) or GPS at 128 kS/s (n = 128; 8 PRNs).
    Returns (blocks, replica, fs, config, acquire_all kwargs)."""
    from gps_jamming_tpu_torch.config import AcquisitionConfig
    from gps_jamming_tpu_torch.models.receiver import galileo
    from gps_jamming_tpu_torch.ops import codes
    if system == "galileo":
        fs, n, hz, lag = 4.192e6, 16768, -1500.0, 5000
        code, rate = galileo.e1b_boc_code(11), galileo.BOC_RATE
        rep = codes.replica_tensor(galileo.replica_table_host(
            fs, n, [4, 11, 19]), dev)
        cfg = AcquisitionConfig(doppler_max_hz=2000.0)
        kw = dict(code_period_s=galileo.PERIOD_S,
                  code_len_chips=float(galileo.BOC_LEN))
    else:
        fs, n, hz, lag = ((2.062e6, 2062, 2600.0, 901)
                          if system == "gps_prime_1031"
                          else (128e3, 128, 2000.0, 37))
        code, rate = codes.gps_ca_code(3), 1.023e6
        rep = codes.gps_replica_table(fs, n, dev)[:8]
        cfg, kw = AcquisitionConfig(), {}
    rng = np.random.default_rng(n)
    i = np.arange(10 * n)
    chip = np.floor((i - lag) * (rate / fs)).astype(int) % code.size
    x = (rng.standard_normal(i.size) + 1j * rng.standard_normal(i.size)
         + np.sqrt(2 * 10 ** (-18 / 10)) * code[chip]
         * np.exp(2j * np.pi * hz * i / fs))
    blocks = torch.from_numpy(x.astype(np.complex64).reshape(10, n)).to(dev)
    return blocks, rep, fs, cfg, kw


@pytest.mark.parametrize("system", ["gps_prime_1031"])
@pytest.mark.parametrize("method", ["pcf", "std", "auto"])
def test_acquire_all_where_the_kernels_do_not_apply(dev, system, method):
    """At n = 2062, which neither B1 and B3 nor the JAX package's Pallas
    kernels take, acquire_all on the card runs the plain surfaces (no
    launch of B1 or B3) and equals the CPU: decisions, lags and Dopplers
    exact, ratios rtol 1e-3."""
    from gps_jamming_tpu_torch.models.receiver import acquisition as acq
    from gps_jamming_tpu_torch.ops import caf
    blocks, rep, fs, cfg, kw = _c1_blocks(system, dev)
    assert not cuda_pcf.supported(blocks.shape[-1])
    assert caf.plain_on_card(blocks, rep.shape[0], pcf=True)
    before = (build.LAUNCHES["pcf"], build.LAUNCHES["caf_std"])
    got = acq.acquire_all(blocks, rep, fs, cfg, method=method, **kw)
    torch.cuda.synchronize()
    assert (build.LAUNCHES["pcf"], build.LAUNCHES["caf_std"]) == before
    want = acq.acquire_all(blocks.cpu(), rep.cpu(), fs, cfg, method=method,
                           **kw)
    for f in ("acquired", "code_phase", "doppler_hz"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    for f in ("peak_ratio", "cn0_dbhz", "peak_power"):
        _assert_close(getattr(got, f).cpu(), getattr(want, f), 1e-3, 0.0)
    assert int(got.acquired.sum()) == 1


@pytest.mark.parametrize("method", ["pcf", "std", "auto"])
def test_acquire_all_raises_where_only_a_tpu_kernel_applies(dev, method):
    """Where the JAX package runs a Pallas kernel and the port's kernel
    does not take n, the card raises from the kernel's wrapper, with no
    launch of B1 or B3, and does not give way to the plain surface: std
    (and 'auto', which resolves to std at 500 Hz bins) at 263936 = 2 * 128
    * 1031 (Galileo E1B at 65.984 MS/s), which v1 takes (2 x 131968) and
    B3 does not, above its cap of 262144. PCF at n = 128 (GPS at 128 kS/s),
    which v3 takes (1 x 128) and which raised before B1 took it, launches
    B1 once and equals the CPU: decisions, lags and Dopplers exact, ratios
    rtol 1e-3."""
    from gps_jamming_tpu_torch.config import AcquisitionConfig
    from gps_jamming_tpu_torch.models.receiver import acquisition as acq
    from gps_jamming_tpu_torch.models.receiver import galileo
    from gps_jamming_tpu_torch.ops import caf
    if method == "pcf":
        blocks, rep, fs, cfg, kw = _c1_blocks("gps_128", dev)
        assert caf.tpu_kernel_takes(128, rep.shape[0], pcf=True)
        before = (build.LAUNCHES["pcf"], build.LAUNCHES["caf_std"])
        got = acq.acquire_all(blocks, rep, fs, cfg, method=method, **kw)
        torch.cuda.synchronize()
        assert (build.LAUNCHES["pcf"], build.LAUNCHES["caf_std"]) == (before[0] + 1,
                                                          before[1])
        want = acq.acquire_all(blocks.cpu(), rep.cpu(), fs, cfg,
                               method=method, **kw)
        for f in ("acquired", "code_phase", "doppler_hz"):
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
        for f in ("peak_ratio", "cn0_dbhz", "peak_power"):
            _assert_close(getattr(got, f).cpu(), getattr(want, f), 1e-3,
                          0.0)
        return
    n = 2 * 128 * 1031
    fs = n / galileo.PERIOD_S
    blocks = _cplx((10, n), seed=n, dev=dev)
    rep = _cplx((3, n), seed=n + 1, dev=dev)
    cfg = AcquisitionConfig(doppler_max_hz=2000.0, doppler_step_hz=500.0)
    kw = dict(code_period_s=galileo.PERIOD_S,
              code_len_chips=float(galileo.BOC_LEN))
    assert caf.tpu_kernel_takes(n, rep.shape[0], pcf=False)
    assert not caf.plain_on_card(blocks, rep.shape[0], pcf=False)
    before = (build.LAUNCHES["pcf"], build.LAUNCHES["caf_std"])
    with pytest.raises(ValueError, match="above 262144"):
        acq.acquire_all(blocks, rep, fs, cfg, method=method, **kw)
    assert (build.LAUNCHES["pcf"], build.LAUNCHES["caf_std"]) == before


def test_cluster_plan_matches_its_twin(dev):
    """The C plan of the correlate stage above 16384 (`gjt_corr_cluster_n1`,
    csrc/caf_std.cu) equals its NumPy twin (`fft_plan.cluster_split`) at
    every n B1 or B3 takes there: a cluster of n1 CTAs up to 131072, none
    (the two passes) above; and B1 and B3 at 20480, 32768, 65536 and 131072
    launch it (one `pcf_correlate_cluster` device kernel, no
    `large_cols_corr`, in torch.profiler's trace)."""
    from torch.profiler import ProfilerActivity, profile
    from gps_jamming_tpu_torch.kernels import fft_plan
    lib = build.load()
    for n in range(16384 + 128, build.FFT_STD_MAX_N + 1, 128):
        if not cuda_caf.supported(n):
            continue
        sp = fft_plan.cluster_split(n)
        assert lib.gjt_corr_cluster_n1(n) == (sp[0] if sp else 0), n
        assert (sp is not None) == (n <= build.FFT_LARGE_MAX_N), n
    for n in (20480, 32768, 65536, 131072):
        blocks = _cplx((2, n), seed=n + 4, dev=dev)
        rep = _cplx((2, n), seed=n + 5, dev=dev)
        calls = [lambda: cuda_caf.caf_accumulate_fused(blocks, rep, [0.0],
                                                       n / 4e-3)]
        if cuda_pcf.supported(n):
            args = _folded_args(blocks, rep, n / 4e-3, 3)
            calls.append(lambda: cuda_pcf.pcf_search(*args, stats_excl=4))
        for call in calls:
            call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            names = [e.key for e in prof.key_averages()]
            assert sum("pcf_correlate_cluster" in k for k in names) == 1, n
            assert not any("large_cols_corr" in k for k in names), n


@pytest.mark.parametrize("method", ["pcf", "std"])
def test_acquire_all_above_16384_launches_the_kernels(dev, method):
    """Galileo E1B at 8.192 MS/s (n = 32768, 3 PRNs, +/-2 kHz): B1 (pcf, in
    its statistics mode) or B3 (std) launches once, and the result equals
    the CPU's: decisions, lags and Dopplers exact, ratios rtol 1e-3."""
    from gps_jamming_tpu_torch.config import AcquisitionConfig
    from gps_jamming_tpu_torch.models.receiver import acquisition as acq
    from gps_jamming_tpu_torch.models.receiver import galileo
    from gps_jamming_tpu_torch.ops import codes
    fs, n, hz, lag = 8.192e6, 32768, -1500.0, 5000
    code = galileo.e1b_boc_code(11)
    rep = codes.replica_tensor(galileo.replica_table_host(
        fs, n, [4, 11, 19]), dev)
    cfg = AcquisitionConfig(doppler_max_hz=2000.0)
    kw = dict(code_period_s=galileo.PERIOD_S,
              code_len_chips=float(galileo.BOC_LEN))
    rng = np.random.default_rng(n)
    i = np.arange(10 * n)
    chip = np.floor((i - lag) * (galileo.BOC_RATE / fs)).astype(int)
    x = (rng.standard_normal(i.size) + 1j * rng.standard_normal(i.size)
         + np.sqrt(2 * 10 ** (-18 / 10)) * code[chip % code.size]
         * np.exp(2j * np.pi * hz * i / fs))
    blocks = torch.from_numpy(x.astype(np.complex64).reshape(10, n)).to(dev)
    before = (build.LAUNCHES["pcf"], build.LAUNCHES["caf_std"])
    got = acq.acquire_all(blocks, rep, fs, cfg, method=method, **kw)
    torch.cuda.synchronize()
    want = (before[0] + (method == "pcf"), before[1] + (method == "std"))
    assert (build.LAUNCHES["pcf"], build.LAUNCHES["caf_std"]) == want
    ref = acq.acquire_all(blocks.cpu(), rep.cpu(), fs, cfg, method=method,
                          **kw)
    for f in ("acquired", "code_phase", "doppler_hz"):
        assert torch.equal(getattr(got, f).cpu(), getattr(ref, f)), f
    for f in ("peak_ratio", "cn0_dbhz", "peak_power"):
        _assert_close(getattr(got, f).cpu(), getattr(ref, f), 1e-3, 0.0)
    assert got.acquired.tolist() == [False, True, False]
    assert abs(int(got.code_phase[1]) - lag) <= 1


def test_welch_at_65536_never_calls_torch_fft(dev, monkeypatch):
    """A CUDA welch_psd at nperseg 65536 (a size the TPU kernel takes, on
    the four-step FFT) launches B2 once and calls no torch.fft function;
    it equals the plain version, computed before the patch."""
    x = _cplx(1 << 19, seed=65536, dev=dev) + (0.5 + 0.1j)
    ref = spectral.welch_psd_plain(x, FS, 65536)

    def refuse(*a, **k):
        raise AssertionError("torch.fft called on the B2 path")

    for name in ("fft", "ifft", "rfft", "fftn"):
        monkeypatch.setattr(torch.fft, name, refuse)
    before = build.LAUNCHES["welch_psd"]
    got = spectral.welch_psd(x, FS, 65536)
    torch.cuda.synchronize()
    assert build.LAUNCHES["welch_psd"] == before + 1
    _assert_close(got, ref, 1e-3, 1e-4 * float(ref.max()))


def test_refine_doppler_on_cuda_matches_cpu(dev):
    """The per-row code resample is equal on the card and the CPU, so the
    fine-Doppler estimate agrees within 0.5 Hz (float32 sums in another
    order)."""
    from gps_jamming_tpu_torch.models.receiver import acquisition as acq
    from gps_jamming_tpu_torch.ops import codes
    table = codes.gps_ca_table()[:4]
    fcode = torch.tensor([1.023e6 * (1.0 + d / 1575.42e6)
                          for d in (-7000.0, -150.0, 2000.0, 6800.0)])
    want = codes.resample_code(torch.from_numpy(table), fcode, FS, 65536)
    got = codes.resample_code(torch.from_numpy(table).to(dev), fcode.to(dev),
                              FS, 65536)
    assert torch.equal(got.cpu(), want)
    x = _cplx(40 * 2048, seed=11, dev=dev)
    i = torch.arange(x.numel(), device=dev, dtype=torch.float64)
    chip = torch.floor((i - 300) * (1.023e6 / FS)).long() % 1023
    sig = torch.from_numpy(table[1]).to(dev)[chip].double() * torch.exp(
        2j * np.pi * 1234.0 * i / FS)
    x = (x + 0.5 * sig).to(torch.complex64)
    args = (table[[1, 1]], [300, 300], [1200.0, 1400.0], FS, 1.023e6)
    fine = acq.refine_doppler(x, *args)
    fine_cpu = acq.refine_doppler(x.cpu(), *args)
    assert float((fine.cpu() - fine_cpu).abs().max()) <= 0.5
    assert float((fine_cpu - 1234.0).abs().max()) <= 20.0



def test_tracker_on_cuda_matches_cpu(dev):
    """The tracker on the card against the CPU: 2 GPS channels over 1000
    epochs with per-channel start offsets (the K-epoch gather). Divisions
    by constants divide by tensors, so the two start bit-equal; sums in
    another order then move the loops apart as they move the JAX package
    and the port apart (tests/test_torch_tracking.py): carr_freq within
    0.05 Hz, code_rem within 1e-3 chips (chip_smoke.py phase 5b's limits),
    equal prompt-I signs after the 800 ms pull-in."""
    from gps_jamming_tpu_torch.config import TrackingConfig
    from gps_jamming_tpu_torch.models.receiver import tracking
    from gps_jamming_tpu_torch.ops import codes
    n_ep, lags, dopps = 1000, (300, 1111), (3000.0, -1234.0)
    i = np.arange(n_ep * 2048 + 2048, dtype=np.float64)
    rng = np.random.default_rng(12)
    x = 0.5 * (rng.standard_normal(i.size) + 1j * rng.standard_normal(i.size))
    for prn, lag, d in zip((7, 21), lags, dopps):
        chip = np.floor((i - lag) * 1.023e6 * (1 + d / 1575.42e6) / FS)
        x = x + codes.gps_ca_code(prn)[chip.astype(np.int64) % 1023] \
            * np.exp(2j * np.pi * d * i / FS)
    x = torch.from_numpy(x.astype(np.complex64))
    table = np.stack([codes.gps_ca_code(p) for p in (7, 21)])
    _, run, _ = tracking.make_tracker(table, FS, TrackingConfig())
    outs = {}
    for d in (dev, torch.device("cpu")):
        st = tracking.init_state(2, [2950.0, -1230.0], [0.0, 0.0], FS,
                                 device=d)
        outs[d.type] = run(st, x.to(d), start_offsets=np.array(lags),
                           n_epochs=n_ep)[1]
    g, c = outs["cuda"], outs["cpu"]
    d_hz = float((g.carr_freq_hz.cpu() - c.carr_freq_hz).abs().max())
    rem = (g.code_rem_chips.cpu() - c.code_rem_chips).abs()
    d_chips = float(torch.minimum(rem, 1023.0 - rem).max())
    assert d_hz < 0.05 and d_chips < 1e-3, (d_hz, d_chips)
    assert torch.equal(torch.sign(g.i_prompt.cpu()[900:]),
                       torch.sign(c.i_prompt[900:]))


def _jammed_set(tmp_path, n=1 << 21, start=0.6):
    """Three antennas at (0, 0), (3, 0), (0, 3) m: unit noise plus a chirp
    jammer at (4, 3) m from `start` of the capture to its end, amplitudes
    from the log-distance model (the JAX simulator's scaling), as uint8
    .bin files."""
    from gps_jamming_tpu_torch.config import DEFAULT_CONFIG as CFG
    from gps_jamming_tpu_torch.ops import iq, pathloss
    ants = [(0.0, 0.0), (3.0, 0.0), (0.0, 3.0)]
    rng = np.random.default_rng(5)
    t = np.arange(n) / FS
    tau = np.maximum(t - start * n / FS, 0.0)
    chirp = np.exp(2j * np.pi * (-500e3 * tau + 0.5 * 500e3 * tau * tau))
    paths = []
    for k, (ax, ay) in enumerate(ants):
        prx = float(pathloss.forward_received_db(
            np.hypot(4.0 - ax, 3.0 - ay), CFG.rssi.tx_power_dbm,
            CFG.rssi.path_loss_exponent, CFG.rssi.frequency_mhz))
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        x += 127.5 * 10 ** (prx / 20) * chirp * (t >= start * n / FS)
        paths.append(str(tmp_path / f"ant{k}.bin"))
        iq.write_iq_file(paths[-1], x)
    return paths, ants


def test_localization_ops_on_cuda_match_cpu(dev, tmp_path):
    """find_onset, range_from_iq and the TDOA/RSSI localizations on the
    card against the CPU on the same captures: onsets and first crossings
    exact (a 1 s capture keeps the float32 cumsum small), distances rtol
    1e-4, lags within 1e-3 samples."""
    from gps_jamming_tpu_torch.config import DEFAULT_CONFIG as CFG
    from gps_jamming_tpu_torch.models import rssi, tdoa
    from gps_jamming_tpu_torch.ops import iq, power
    paths, ants = _jammed_set(tmp_path)
    for p in paths:
        x = torch.from_numpy(iq.read_iq_file(p, convention="centered"))
        args = (CFG.tdoa.noise_sample_size, CFG.tdoa.detection_window_size,
                CFG.tdoa.detection_threshold_factor)
        assert int(power.find_onset(x.to(dev), *args)) == \
            int(power.find_onset(x, *args)) > 0
        xn = torch.from_numpy(iq.read_iq_file(p, convention="normalized"))
        g, c = rssi.range_from_iq(xn.to(dev), CFG.rssi), \
            rssi.range_from_iq(xn, CFG.rssi)
        assert int(g.onset_index) == int(c.onset_index) > 0
        assert float(g.distance_m) == pytest.approx(float(c.distance_m),
                                                    rel=1e-4)
    caps = [iq.read_iq_file(p, convention="centered") for p in paths]
    g = tdoa.localize(caps, ants, FS, device=dev)
    c = tdoa.localize(caps, ants, FS, device="cpu")
    assert g["onsets"] == c["onsets"]
    np.testing.assert_allclose([p["lag_samples"] for p in g["pairs"]],
                               [p["lag_samples"] for p in c["pairs"]],
                               atol=1e-3)


def test_analyze_capture_on_cuda_matches_cpu(dev, tmp_path):
    """The batch product path with the receiver on (kernel B1 in stats
    mode, one launch) on the card against the CPU: ranges, events, flags
    and records equal, RSSI distances rtol 1e-4."""
    from gps_jamming_tpu_torch.runtime import pipeline
    paths, ants = _jammed_set(tmp_path)
    before = build.LAUNCHES["pcf"]
    g = pipeline.analyze_capture(paths, ants, streaming=False)
    assert build.LAUNCHES["pcf"] == before + 1
    c = pipeline.analyze_capture(paths, ants, streaming=False, device="cpu")
    assert g.power_ranges == c.power_ranges and len(g.events) == 1
    assert g.events == c.events
    for k in c.flags_trace:
        assert np.array_equal(g.flags_trace[k], c.flags_trace[k]), k
    assert g.telemetry.records == c.telemetry.records
    np.testing.assert_allclose(g.localization["distances"],
                               c.localization["distances"], rtol=1e-4)
    x, y = g.localization["location_meters"]
    assert np.hypot(x - 4.0, y - 3.0) < 3.0
    assert g.tdoa_result is not None and len(g.tdoa_result["pairs"]) == 3


def test_streaming_detect_without_receiver_on_cuda_matches_cpu(dev,
                                                                tmp_path):
    """streaming=True with the receiver off: the file pre-scan and the grid
    searches on the card, the streamed ranging and onsets on the host; the
    same ranges, events and TDOA onsets as the CPU, distances rtol 1e-6
    (host NumPy on both sides)."""
    from gps_jamming_tpu_torch.runtime import pipeline
    paths, ants = _jammed_set(tmp_path)
    kw = dict(run_receiver=False, streaming=True)
    g = pipeline.analyze_capture(paths, ants, **kw)
    c = pipeline.analyze_capture(paths, ants, device="cpu", **kw)
    assert g.power_ranges == c.power_ranges and g.events == c.events
    assert len(g.events) == 1 and g.receiver is None
    np.testing.assert_allclose(g.localization["distances"],
                               c.localization["distances"], rtol=1e-6)
    assert g.tdoa_result["onsets"] == c.tdoa_result["onsets"]


def test_cli_runs_on_the_card_by_default(dev, tmp_path):
    """`python -m gps_jamming_tpu_torch` with no --device: detect (batch
    receiver), localize, calibrate and receiver exit 0 and print the same
    events, ranges and RSSI distances (rtol 1e-4) as with --device cpu."""
    import json
    import os
    import subprocess
    import sys
    paths, _ = _jammed_set(tmp_path)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def run(*args):
        r = subprocess.run([sys.executable, "-m", "gps_jamming_tpu_torch",
                            *args], capture_output=True, text=True,
                           cwd=repo, timeout=600)
        assert r.returncode == 0, r.stderr[-2000:]
        return json.loads(r.stdout)

    for argv in (["detect", *paths, "--batch-receiver"],
                 ["localize", *paths], ["calibrate", paths[1]],
                 ["receiver", paths[0]]):
        g, c = run(*argv), run(*argv, "--device", "cpu")
        assert list(g) == list(c), argv
        for k in ("events", "power_ranges_bytes", "events_at_threshold",
                  "acquired", "fix"):
            assert g.get(k) == c.get(k), (argv, k)
        loc = "localization" if argv[0] == "detect" else "rssi"
        if loc in g:
            np.testing.assert_allclose(g[loc]["distances"],
                                       c[loc]["distances"], rtol=1e-4)


# --- the streaming receiver on the card --------------------------------------

WIRE_CONVS = (("i8", np.float32(0.5), np.float32(1.0)),
              ("i8", np.float32(0.5), np.float32(1.0 / 127.5)),
              ("i4", np.float32(3.25)), ("i2", np.float32(12.0)),
              ("i1", np.float32(20.0)))


@pytest.mark.parametrize("conv", WIRE_CONVS, ids=lambda c: str(c[0]))
def test_wire_unpack_on_cuda_matches_cpu(dev, conv):
    """`StreamingReceiver._ingest` of every byte value on the card equals
    the CPU's exactly (the wire unpack is integer bit work and one float32
    multiply-add)."""
    from gps_jamming_tpu_torch.runtime import rx_stream
    rx = rx_stream.StreamingReceiver(1.024e6, n_slots=2, segment_s=0.25)
    rx._ingest_conv = conv
    b = np.arange(256, dtype=np.uint8).view(np.int8)
    planes = torch.from_numpy(np.stack([b, b[::-1]]).copy())
    g = rx._ingest(planes.to(dev))
    assert g.is_cuda and g.dtype == torch.complex64
    assert torch.equal(g.cpu(), rx._ingest(planes))


_RX_FS = 1.024e6
_JAM_S = (1.5, 3.0)


@pytest.fixture(scope="module")
def jammed_gps_bin(tmp_path_factory):
    """4.5 s of the 24-satellite GPS shell at 1.024 MS/s (the port's NumPy
    renderer, seed 6), a seeded broadband jam of amplitude 400 from 1.5 to
    3.0 s, x12 into a uint8 .bin (tests/test_torch_rx_stream.py's)."""
    from gps_jamming_tpu_torch.ops import iq
    from gps_jamming_tpu_torch.sim import constellation
    n = int(4.5 * _RX_FS)
    x, _, _ = constellation.simulate_constellation(
        constellation.gps_shell(345600.0), (50.06, 19.94, 219.0),
        345600.0 - 1.3, n, _RX_FS, noise_std=0.4, seed=6)
    rng = np.random.default_rng(3)
    s0, s1 = int(_JAM_S[0] * _RX_FS), int(_JAM_S[1] * _RX_FS)
    x[s0:s1] += 400.0 * (rng.standard_normal(s1 - s0)
                         + 1j * rng.standard_normal(s1 - s0))
    path = str(tmp_path_factory.mktemp("rxs") / "jam.bin")
    iq.write_iq_file(path, x * 12.0)
    return path


def _stream_rx(device=None):
    from gps_jamming_tpu_torch.runtime import rx_stream
    return rx_stream.StreamingReceiver(_RX_FS, n_slots=4, segment_s=0.5,
                                       device=device)


def test_streaming_receiver_on_cuda_matches_cpu(dev, jammed_gps_bin):
    """The streaming receiver on the card against the CPU on a jammed
    capture: B1 launched once per acquisition attempt, the same spans (a
    reset and a re-acquisition among them), and on the clean epochs after
    the pull-in carr_freq within 0.05 Hz and code_rem within 1e-3 chips
    (chip_smoke.py phase 5b's limits)."""
    before = build.LAUNCHES["pcf"]
    rx_g = _stream_rx()
    g = rx_g.process_file(jammed_gps_bin)
    assert build.LAUNCHES["pcf"] - before == rx_g.last_profile["n_acquire_calls"]
    rx_c = _stream_rx("cpu")
    c = rx_c.process_file(jammed_gps_bin)
    assert set(g.tracked_spans) == set(c.tracked_spans)
    end = c.cn0_epochs.size
    assert any(b < end for _, _, b in g.tracked_spans)
    sats = [s for s, _, _ in g.tracked_spans]
    assert any(sats.count(s) > 1 for s in sats)
    j0, j1 = int(_JAM_S[0] * 1000), int(_JAM_S[1] * 1000)
    civ = {(iv.sat_id, iv.start_epoch): iv for iv in rx_c.last_intervals}
    for iv in rx_g.last_intervals:
        w = civ[(iv.sat_id, iv.start_epoch)]
        local = np.arange(iv.n_epochs)
        glob = iv.start_epoch + local
        m = ((glob < j0) & (local >= 1000)) | (
            (iv.start_epoch >= j1) & (local >= 500))
        if not m.any():
            continue
        assert np.abs(iv.carr_freq[m] - w.carr_freq[m]).max() <= 0.05
        d = np.abs(iv.code_rem[m].astype(np.float64) - w.code_rem[m])
        assert np.minimum(d, 1023.0 - d).max() <= 1e-3


def test_streaming_resume_on_cuda_is_bitwise(dev, jammed_gps_bin, tmp_path):
    """A run killed after segment 5 and resumed from its checkpoint equals
    the uninterrupted run on the card exactly."""
    class Kill(Exception):
        pass

    def kill(done, n_total, snapshot):
        if done == 5:
            raise Kill()

    rx_a = _stream_rx()
    a = rx_a.process_file(jammed_gps_bin)
    ck = str(tmp_path / "rx.ckpt")
    with pytest.raises(Kill):
        _stream_rx().process_file(jammed_gps_bin, checkpoint_path=ck,
                                  checkpoint_every_s=1.0, segment_cb=kill)
    rx_c = _stream_rx()
    c = rx_c.process_file(jammed_gps_bin, checkpoint_path=ck,
                          checkpoint_every_s=1.0, resume=True)
    assert c.tracked_spans == a.tracked_spans
    assert np.array_equal(c.cn0_epochs, a.cn0_epochs)
    for x, y in zip(rx_a.last_intervals, rx_c.last_intervals, strict=True):
        for f in ("i_prompt", "code_rem", "carr_freq", "cn0"):
            assert np.array_equal(getattr(x, f), getattr(y, f)), f


def test_window_upload_overlaps_compute_and_waits_on_its_event(dev):
    """The IO worker's upload runs on its own stream while the consumer's
    stream is busy, and the consumer reads the window only after waiting
    on the upload's event: the copy completes before the running
    matrix products do, and the window read after `_take` is the host's."""
    import threading
    rx = _stream_rx()
    w = np.random.default_rng(9).integers(-128, 128, (2, 1 << 23),
                                          dtype=np.int8)
    a = torch.randn(8192, 8192, device=dev)
    torch.cuda.synchronize()
    for _ in range(30):                          # ~1 s of float32 GEMMs
        a = a @ a
        a = a / a.abs().max()
    busy = torch.cuda.current_stream(dev)
    out = {}
    t = threading.Thread(target=lambda: out.update(r=rx._upload(w)))
    t.start()
    t.join()
    d, ev = out["r"]
    assert ev is not None and ev.query()          # the copy has landed
    assert not busy.query(), "the GEMMs ended before the upload: no overlap"
    got = rx._take(d, ev)
    assert torch.equal(got.cpu(), torch.from_numpy(w))
    torch.cuda.synchronize()


# --- the operator's verbs: B2 over rows, the simulator, the dashboard -----

@pytest.mark.parametrize("rows,n,nperseg", [(16, 1 << 17, 1024),
                                            (3, 9 * 1536 // 2 + 77, 1536),
                                            (1, 4096, 64)])
def test_welch_kernel_over_rows_matches_plain(dev, rows, n, nperseg):
    """B2 over (rows, n): one launch per row, each row equal to the plain
    version of that row (the tolerance of test_welch_kernel_matches_plain),
    and bit-equal to the 1-D call on the row."""
    x = _cplx((rows, n), seed=rows + n, dev=dev)
    before = build.LAUNCHES["welch_psd"]
    got = cuda_psd.welch_psd_fused(x, FS, nperseg)
    torch.cuda.synchronize()
    assert build.LAUNCHES["welch_psd"] == before + rows
    assert got.shape == (rows, nperseg)
    for r in range(rows):
        ref = spectral.welch_psd_plain(x[r], FS, nperseg)
        torch.testing.assert_close(got[r], ref, rtol=1e-3,
                                   atol=1e-4 * float(ref.max()))
        assert torch.equal(got[r], cuda_psd.welch_psd_fused(x[r], FS,
                                                            nperseg))


def test_spectrogram_runs_b2_per_chunk_on_cuda(dev, tmp_path):
    """spectral.welch_psd sends a 2-D or 3-D CUDA input to B2, one launch
    per row; the spectrogram of a file has one row per chunk, the same on
    the card as on the CPU within 1e-3 dB, at every batch size; an nperseg
    B2 does not take (36864 = 9 * 4096, which the TPU kernel does not take
    either) stays plain."""
    x = _cplx((2, 3, 1 << 15), seed=4, dev=dev)
    before = build.LAUNCHES["welch_psd"]
    got = spectral.welch_psd(x, FS, 1024)
    assert build.LAUNCHES["welch_psd"] == before + 6 and got.shape == (2, 3, 1024)
    spectral.welch_psd(_cplx((2, 1 << 17), seed=5, dev=dev), FS, 36864)
    assert build.LAUNCHES["welch_psd"] == before + 6
    from gps_jamming_tpu_torch.ops import iq
    rng = np.random.default_rng(3)
    n = 20 * 32768 + 99
    iq.write_iq_file(str(tmp_path / "c.bin"),
                     (rng.standard_normal(n) + 1j * rng.standard_normal(n))
                     * 8.0)
    cpu = spectral.spectrogram_file(str(tmp_path / "c.bin"), FS, 32768,
                                    1024, device="cpu")
    for b in (1, 3, 16):
        before = build.LAUNCHES["welch_psd"]
        got = spectral.spectrogram_file(str(tmp_path / "c.bin"), FS, 32768,
                                        1024, batch_chunks=b)
        assert build.LAUNCHES["welch_psd"] == before + 20
        np.testing.assert_allclose(got, cpu, atol=1e-3, rtol=0)


def test_simulator_on_cuda_matches_cpu(dev, tmp_path):
    """The deterministic simulator on the card against the CPU: the time
    ramp bit for bit (sample_times divides by a tensor), the waveforms
    within 4 ulp of their amplitude (cos and sin), the gate, roll and
    envelopes exactly on equal inputs, and the written bytes within 1 LSB
    with under 1e-3 of them differing."""
    from gps_jamming_tpu_torch.ops import codes
    from gps_jamming_tpu_torch.sim import glo, gps, jammers, mix, scenario
    n = (1 << 24) + 4096
    assert torch.equal(codes.sample_times(n, FS, dev).cpu(),
                       codes.sample_times(n, FS, "cpu"))
    m = 1 << 18
    for fn in (jammers.cw, jammers.chirp, jammers.pulsed):
        torch.testing.assert_close(fn(m, FS, device=dev).cpu(),
                                   fn(m, FS, device="cpu"), rtol=0,
                                   atol=2.4e-7)
    sat = gps.SatelliteSignal(prn=17, doppler_hz=-3210.5,
                              code_phase_chips=12.75, amplitude=2.5,
                              nav_bits=(1, -1, -1, 1), bit_periods=20)
    torch.testing.assert_close(gps.ca_baseband(sat, m, FS, dev).cpu(),
                               gps.ca_baseband(sat, m, FS, "cpu"), rtol=0,
                               atol=2.4e-7 * 2.5)
    gs = glo.GloSignal(freq_ch=2, doppler_hz=-700.0, symbols=(0, 1, 1))
    torch.testing.assert_close(glo.baseband(gs, 30000, 10e6, device=dev)
                               .cpu(), glo.baseband(gs, 30000, 10e6,
                                                    device="cpu"),
                               rtol=0, atol=2.4e-7)
    a = jammers.chirp(m, FS, device="cpu")
    b = jammers.cw(m, FS, device="cpu") * 30.0
    for f in (lambda u, v: mix.inject_static(u, v, FS, 0.00123456, 0.05,
                                             2.0),
              lambda u, v: mix.spoof_mix(u, v, FS, 0.01, 0.02, 4.0),
              lambda u, v: mix.finalize_uint8_domain(u * 200.0 + v)):
        assert torch.equal(f(a.to(dev), b.to(dev)).cpu(), f(a, b))
    d = torch.tensor([5.0, 15.0, 12.0, 30.0])
    assert torch.equal(mix.trajectory_power_profile(d.to(dev), 7, 20.0)
                       .cpu(), mix.trajectory_power_profile(d, 7, 20.0))
    ants = [(0.0, 0.0), (3.0, 0.0), (0.0, 3.0)]
    for kind in ("cw", "chirp", "pulsed"):
        scn = scenario.JammerScenario(kind=kind, position_m=(4.0, 3.0),
                                      start_s=0.1, duration_s=10.0)
        pg = [str(tmp_path / f"g{i}.bin") for i in range(3)]
        pc = [str(tmp_path / f"c{i}.bin") for i in range(3)]
        scenario.write_capture_set(scn, ants, pg, m, FS, noise_std=0.0)
        scenario.write_capture_set(scn, ants, pc, m, FS, noise_std=0.0,
                                   device="cpu")
        for p, q in zip(pg, pc):
            x = np.fromfile(p, np.uint8).astype(np.int16)
            y = np.fromfile(q, np.uint8).astype(np.int16)
            assert np.abs(x - y).max() <= 1 and np.mean(x != y) < 1e-3
    # the noise: seeded on the card, unit variance per component
    scn = scenario.JammerScenario(kind="broadband", start_s=0.0,
                                  duration_s=1.0, seed=3)
    z = scenario.render_antenna_capture(scn, (0.0, 0.0), m, FS,
                                        noise_std=0.0)
    assert torch.equal(z, scenario.render_antenna_capture(
        scn, (0.0, 0.0), m, FS, noise_std=0.0))
    amp = scenario.jammer_amplitude_at(scn, float(np.hypot(10.0, 5.0)))
    v = float(z.real.double().var()) / amp ** 2
    assert abs(v - 1.0) < 0.03


def test_dashboard_start_stop_start_on_cuda(dev, tmp_path):
    """The controller's analysis thread on the card: a run to completion
    (1 s: no whole receiver segment, so no B1 launch), a stop in the
    middle of a streaming analysis ("stopped by user", no receiver worker
    left), and a restart equal to the first run."""
    import json
    import threading
    import urllib.error
    import urllib.request

    from gps_jamming_tpu_torch.runtime import dashboard
    paths, ants = _jammed_set(tmp_path)
    long_path = str(tmp_path / "long.bin")
    np.random.default_rng(0).integers(
        0, 256, int(2 * 20.0 * FS), dtype=np.uint8).tofile(long_path)
    state = dashboard.DashboardState()
    ctl = dashboard.AnalysisController(state)
    assert ctl.device.type == "cuda"
    srv = dashboard.make_server(state, port=0, controller=ctl)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def post(body):
        req = urllib.request.Request(f"{base}/control",
                                     data=json.dumps(body).encode())
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status
        except urllib.error.HTTPError as e:
            return e.code

    def get():
        with urllib.request.urlopen(f"{base}/state.json", timeout=5) as r:
            return json.loads(r.read())

    def run_to_end():
        before = build.LAUNCHES["pcf"]
        assert post({"action": "start", "files": paths,
                     "positions": [list(a) for a in ants]}) == 200
        ctl.join(600)
        st = get()
        assert st["status"] == "analysis complete", st["status"]
        assert build.LAUNCHES["pcf"] == before       # 1 s: no whole segment
        return st

    def workers():
        return sorted(t.name for t in threading.enumerate()
                      if t.name.startswith(("rx-io", "rx-dec")))

    try:
        before_threads = workers()
        first = run_to_end()
        assert len(first["events"]) == 1 and first["records"] == 10
        # stop at once: on the card a segment of noise takes well under
        # a poll's reach, so the flag is set before the first emission
        assert post({"action": "start", "files": [long_path],
                     "emit_every_s": 0.1}) == 200
        assert post({"action": "stop"}) == 200
        ctl.join(300)
        assert get()["status"] == "stopped by user"
        assert workers() == before_threads
        again = run_to_end()
        for k in ("records", "events", "triangulation"):
            assert again[k] == first[k], k
    finally:
        srv.shutdown()
        srv.server_close()


# --- the sharded path on a mesh of one repeated card ---------------------

def _sharded_case(n_ant, n_time, block, seed):
    from gps_jamming_tpu_torch.parallel import fusion
    rng = np.random.default_rng(seed)
    s = (rng.standard_normal((n_ant, n_time * block))
         + 1j * rng.standard_normal((n_ant, n_time * block)))
    s = s.astype(np.complex64)
    return s, fusion.shard_blocks(s, n_ant, n_time, block)


@pytest.mark.parametrize("method", ["pcf", "std"])
def test_sharded_acquisition_on_a_repeated_card(dev, method):
    """A 2 x 4 mesh of one card: one search per shard (B1 for 'pcf', B3
    for 'std'), so its count in build.LAUNCHES rises by 8; each antenna's surface equals the
    single-device search of its 16 periods (rtol 2e-4, atol 1e-3 * max),
    and a second run gives the same bits."""
    from gps_jamming_tpu_torch.ops import caf, codes
    from gps_jamming_tpu_torch.parallel import fusion
    from gps_jamming_tpu_torch.parallel import mesh as mesh_lib
    n_code, gb = 2048, 2
    streams, blocks = _sharded_case(2, 4, 4 * n_code, seed=31)
    planes = codes.gps_replica_table_host(FS, n_code)
    freqs = caf.doppler_bins(7000.0, 500.0)
    m = mesh_lib.make_mesh(2, 4, devices=[dev] * 8)
    kernel = "pcf" if method == "pcf" else "caf_std"
    before = build.LAUNCHES[kernel]
    surf = fusion.sharded_caf_acquire(blocks, m, planes, freqs, FS,
                                      method=method, group_blocks=gb)
    torch.cuda.synchronize()
    assert build.LAUNCHES[kernel] == before + 8
    assert surf.device == dev
    rep = codes.replica_tensor(planes, dev)
    for a in range(2):
        x = torch.from_numpy(streams[a].reshape(-1, n_code)).to(dev)
        want = (caf.caf_accumulate_pcf(x, rep, FS, n_groups=16 // gb)
                if method == "pcf" else
                caf.caf_accumulate(x, rep, freqs, FS))
        _assert_close(surf[a], want, 2e-4, 1e-3 * float(want.max()))
    again = fusion.sharded_caf_acquire(blocks, m, planes, freqs, FS,
                                       method=method, group_blocks=gb)
    assert torch.equal(surf, again)


def test_sharded_psd_on_a_repeated_card(dev):
    """A 2 x 4 mesh of one card: B2 once per time shard (8 launches); the
    per-antenna PSDs within rtol 2e-4 of `welch_psd` of the whole stream on
    the card (one launch each), the fused PSD of their mean, the power map
    rtol 1e-5 of `chunk_power`."""
    from gps_jamming_tpu_torch.config import DetectorConfig, SpectralConfig
    from gps_jamming_tpu_torch.ops import power
    from gps_jamming_tpu_torch.parallel import fusion
    from gps_jamming_tpu_torch.parallel import mesh as mesh_lib
    streams, blocks = _sharded_case(2, 4, 1 << 17, seed=32)
    m = mesh_lib.make_mesh(2, 4, devices=[dev] * 8)
    before = build.LAUNCHES["welch_psd"]
    fused, per_ant, pm = fusion.sharded_psd_and_power(
        blocks, m, FS, DetectorConfig(), SpectralConfig())
    torch.cuda.synchronize()
    assert build.LAUNCHES["welch_psd"] == before + 8
    x = torch.from_numpy(streams).to(dev)
    want = torch.stack([spectral.welch_psd(r, FS, 1024) for r in x])
    assert build.LAUNCHES["welch_psd"] == before + 10
    _assert_close(per_ant, want, 2e-4, 0.0)
    _assert_close(fused, want.mean(dim=0), 2e-4, 0.0)
    _assert_close(pm, power.chunk_power(x, 32768), 1e-5, 0.0)


def test_sharded_analysis_on_a_repeated_card_matches_cpu(dev, tmp_path):
    """`analyze_capture_sharded` over 6 entries of one card against 6 CPU
    entries on a 1 s jammed set: B2 and B1 six times each; ranges, PRNs,
    Dopplers and lags equal, baseline and threshold rtol 1e-5, peaks rtol
    2e-4, the fused peak within 1e-3 dB."""
    from gps_jamming_tpu_torch.runtime import sharded
    paths, _ = _jammed_set(tmp_path)
    before = (build.LAUNCHES["welch_psd"], build.LAUNCHES["pcf"])
    g = sharded.analyze_capture_sharded(paths, devices=[dev] * 6)
    assert (build.LAUNCHES["welch_psd"] - before[0], build.LAUNCHES["pcf"] - before[1]) \
        == (6, 6)
    c = sharded.analyze_capture_sharded(paths, devices=["cpu"] * 6)
    assert g["mesh"] == c["mesh"] == {"antenna": 3, "time": 2, "devices": 6}
    assert abs(g["psd_fused_peak_db"] - c["psd_fused_peak_db"]) < 1e-3
    assert g["psd_fused_peak_freq_hz"] == c["psd_fused_peak_freq_hz"]
    for ga, ca in zip(g["per_antenna"], c["per_antenna"]):
        assert ga["power_ranges_bytes"] == ca["power_ranges_bytes"] != []
        for k in ("baseline", "threshold"):
            assert ga[k] == pytest.approx(ca[k], rel=1e-5)
    for ga, ca in zip(g["acquisition"], c["acquisition"]):
        assert [(r["prn"], r["doppler_hz"]) for r in ga] == \
            [(r["prn"], r["doppler_hz"]) for r in ca]
        np.testing.assert_allclose([r["peak"] for r in ga],
                                   [r["peak"] for r in ca], rtol=2e-4)
    assert g["tdoa_pairs"] == c["tdoa_pairs"]


def test_sharded_three_files_on_one_card_upload_their_bytes(dev, tmp_path):
    """`detect --devices 1` over three files, a 3 x 1 mesh of one card:
    the upload counter reads 2 B per analysed sample (the raw bytes, made
    complex64 on the card) and 8 per TDOA slice sample; ranges, PRNs,
    Dopplers and lags equal the `devices=['cpu']` answers."""
    from gps_jamming_tpu_torch.parallel import mesh as mesh_lib
    from gps_jamming_tpu_torch.runtime import sharded
    paths, _ = _jammed_set(tmp_path)
    L = 1 << 21                      # 64 whole chunks of 32768 a file
    mesh_lib.reset_upload_bytes()
    g = sharded.analyze_capture_sharded(paths, n_devices=1, devices=[dev])
    assert mesh_lib.upload_bytes() == 3 * (2 * L + 8 * 50_000)
    c = sharded.analyze_capture_sharded(paths, devices=["cpu"])
    assert g["mesh"] == c["mesh"] == {"antenna": 3, "time": 1, "devices": 3}
    for ga, ca in zip(g["per_antenna"], c["per_antenna"], strict=True):
        assert ga["power_ranges_bytes"] == ca["power_ranges_bytes"] != []
    for ga, ca in zip(g["acquisition"], c["acquisition"], strict=True):
        assert [(r["prn"], r["doppler_hz"]) for r in ga] == \
            [(r["prn"], r["doppler_hz"]) for r in ca]
    assert g["tdoa_pairs"] == c["tdoa_pairs"]


def test_sharded_files_go_up_from_pinned_rows(dev, tmp_path, monkeypatch):
    """`detect --devices 1` over two different three-file sets of one
    size, one pass after the other (the second gets the first's freed
    page-locked blocks back): the rows handed to `place_blocks` are
    pinned, and under the profiler each file's row is one `Pinned` HtoD
    record; from pageable rows the same three copies are `Pageable`. Each
    pass's ranges, PRNs, Dopplers and lags equal the `devices=['cpu']`
    answers, and its whole answer equals, bitwise, the card's from
    pageable rows."""
    from gps_jamming_tpu_torch.parallel import mesh as mesh_lib
    from gps_jamming_tpu_torch.runtime import profiling, sharded
    sets = []
    for name, start in (("a", 0.6), ("b", 0.3)):
        (tmp_path / name).mkdir()
        sets.append(_jammed_set(tmp_path / name, start=start)[0])
    place, read_raw = mesh_lib.place_blocks, sharded.iq_ops.read_raw
    pinned = []

    def spy(blocks, mesh):
        if not mesh_lib._is_grid(blocks):     # the host rows, not a grid
            pinned.extend(r.is_pinned() for r in blocks)
        return place(blocks, mesh)
    monkeypatch.setattr(sharded.mesh_lib, "place_blocks", spy)

    def htod(paths):
        """A pass's answer and its (Pinned, Pageable) HtoD record counts,
        traced after the pre-roll that keeps the profiler's first device
        records (`profiling.torch_trace`)."""
        with profiling.torch_trace(str(tmp_path / f"tr{len(pinned)}"),
                                   dev) as prof:
            out = sharded.analyze_capture_sharded(paths, n_devices=1,
                                                  devices=[dev])
            torch.cuda.synchronize(dev)
        names = [e.name() for e in prof.profiler.kineto_results.events()
                 if "HtoD" in e.name()]
        return out, tuple(sum(k in n for n in names)
                          for k in ("Pinned", "Pageable"))

    got = [htod(p) for p in sets]
    assert pinned == [True] * 6
    small = got[0][1][1]                 # replica table, TDOA slices, ...
    assert [n for _, n in got] == [(3, small)] * 2
    monkeypatch.setattr(sharded.iq_ops, "read_raw",
                        lambda p, n, pin=False: read_raw(p, n))
    pageable = [htod(p) for p in sets]
    assert pinned[6:] == [False] * 6
    assert [n for _, n in pageable] == [(0, small + 3)] * 2
    for (g, _), (w, _), paths in zip(got, pageable, sets):
        assert g == w
        c = sharded.analyze_capture_sharded(paths, devices=["cpu"])
        for ga, ca in zip(g["per_antenna"], c["per_antenna"], strict=True):
            assert ga["power_ranges_bytes"] == ca["power_ranges_bytes"] != []
        for ga, ca in zip(g["acquisition"], c["acquisition"], strict=True):
            assert [(r["prn"], r["doppler_hz"]) for r in ga] == \
                [(r["prn"], r["doppler_hz"]) for r in ca]
        assert g["tdoa_pairs"] == c["tdoa_pairs"]
    assert got[0][0]["per_antenna"] != got[1][0]["per_antenna"]


def test_sharded_acquisition_on_distinct_cards(dev):
    """Where the machine has two or more cards: the 'pcf' search on a
    2 x 1 mesh of two distinct cards equals the repeated-card mesh bitwise
    (each card runs the same kernel on the same shard), and each result
    is read on the mesh's first card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from gps_jamming_tpu_torch.ops import codes
    from gps_jamming_tpu_torch.parallel import fusion
    from gps_jamming_tpu_torch.parallel import mesh as mesh_lib
    _, blocks = _sharded_case(2, 1, 8 * 2048, seed=33)
    planes = codes.gps_replica_table_host(FS, 2048)
    two = [torch.device("cuda", 0), torch.device("cuda", 1)]
    got = fusion.sharded_caf_acquire(
        blocks, mesh_lib.make_mesh(2, 1, devices=two), planes, None, FS,
        method="pcf", group_blocks=4)
    want = fusion.sharded_caf_acquire(
        blocks, mesh_lib.make_mesh(2, 1, devices=[dev] * 2), planes, None,
        FS, method="pcf", group_blocks=4)
    assert got.device == two[0]
    assert torch.equal(got, want)
