"""Kernel F1's plain version (`ops.cuda_front.block_front` on the CPU)
against the JAX package's stages, and the arithmetic the kernel's chunk
power rests on.

- On a CPU tensor `block_front` makes no launch and gives what the JAX
  package's front gives (`iq.int8_to_planar`, `power.chunk_power_p`,
  `power_baseline`, `power_threshold_linear`, the compare; as `bench.py`'s
  step forms it): x bit for bit, pm within rtol 1e-6 (two float32
  reductions), the flags equal, at the main path's 512k samples,
  `entry()`'s 128k, one whole chunk, less than one chunk and a partial
  last chunk, on noise and on a jammed block; `entry._front` does so at
  the JAX package's configured percentile and rise.
- The kernel sums 4|x|^2 = (2i+1)^2 + (2q+1)^2 as integers and rounds
  each chunk's mean once; the plain version's float32 reduction lies
  within 1e-6 of that correctly rounded mean (the card tests' rtol for
  pm), here in NumPy with exact integers.
- A tensor on a device that is neither the CPU nor CUDA raises.
"""
import fractions

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_jamming_tpu.config import DEFAULT_CONFIG as JCFG
from gps_jamming_tpu.ops import iq as jiq
from gps_jamming_tpu.ops import power as jpower
from gps_jamming_tpu_torch import entry
from gps_jamming_tpu_torch.kernels import build
from gps_jamming_tpu_torch.ops import cuda_front, iq, power

torch.set_num_threads(2)

CHUNK = 32768


def _raw(n, seed, jam=None):
    """(2n,) int8 bytes of unit-scale noise; `jam` (lo, hi) samples carry
    a strong tone, so that their chunks rise above the threshold."""
    rng = np.random.default_rng(seed)
    v = rng.normal(0.0, 6.0, 2 * n)
    if jam is not None:
        lo, hi = jam
        t = np.arange(hi - lo)
        v[2 * lo:2 * hi:2] += 60.0 * np.cos(0.3 * t)
        v[2 * lo + 1:2 * hi:2] += 60.0 * np.sin(0.3 * t)
    return torch.from_numpy(np.clip(np.round(v), -128, 127).astype(np.int8))


def _jax_front(raw, percentile, rise_db):
    """(x, pm, flags) of the JAX package's front on the same bytes."""
    xp = jiq.int8_to_planar(jnp.asarray(raw.numpy()))
    pm = jpower.chunk_power_p(xp, CHUNK)
    thr = jpower.power_threshold_linear(
        jpower.power_baseline(pm, percentile), rise_db)
    x = (np.asarray(xp.re) + 1j * np.asarray(xp.im)).astype(np.complex64)
    return x, np.asarray(pm), np.asarray(pm > thr)


def _assert_front(got, want):
    x, pm, flags = (g.numpy() for g in got)
    np.testing.assert_array_equal(x.view(np.float32),
                                  want[0].view(np.float32))
    np.testing.assert_allclose(pm, want[1], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(flags, want[2])


CASES = [(1 << 19, None), (1 << 17, None), (CHUNK, None), (20000, None),
         ((1 << 19) + 1000, None), (1 << 19, (3 * CHUNK, 5 * CHUNK + 77)),
         ((1 << 19) + 1000, (15 * CHUNK, (1 << 19) + 1000))]


@pytest.mark.parametrize("n,jam", CASES)
def test_plain_front_is_the_composition(n, jam):
    raw = _raw(n, seed=n % 997, jam=jam)
    before = build.LAUNCHES["front"]
    got = cuda_front.block_front(raw, CHUNK, 5.0, 6.0)
    assert build.LAUNCHES["front"] == before            # no kernel on the CPU
    k = -(-n // CHUNK)
    assert got[0].dtype == torch.complex64 and got[0].shape == (n,)
    assert got[1].dtype == torch.float32 and got[1].shape == (k,)
    assert got[2].dtype == torch.bool and got[2].shape == (k,)
    _assert_front(got, _jax_front(raw, 5.0, 6.0))
    if jam is not None:
        assert bool(got[2].any()) and not bool(got[2].all())


def test_entry_front_runs_the_configured_front():
    raw = _raw(1 << 17, seed=4, jam=(CHUNK, 2 * CHUNK))
    before = build.LAUNCHES["front"]
    got = entry._front(raw)
    assert build.LAUNCHES["front"] == before
    assert entry.CHUNK == CHUNK
    assert bool(got[2].any()) and not bool(got[2].all())
    _assert_front(got, _jax_front(raw, JCFG.detector.baseline_percentile,
                                  JCFG.detector.power_rise_db))


def _exact_means(raw, chunk):
    """Each chunk's mean |x|^2 + 1e-10 as the kernel forms it: the integer
    sum of (2i+1)^2 + (2q+1)^2 over 4 * len, rounded once to float32."""
    v = 2 * raw.numpy().astype(np.int64) + 1
    p4 = v[0::2] ** 2 + v[1::2] ** 2
    out = []
    for lo in range(0, p4.size, chunk):
        s = int(p4[lo:lo + chunk].sum())
        q = fractions.Fraction(s, 4 * p4[lo:lo + chunk].size)
        f = np.float32(float(q))
        # float(q) rounds once to double; step to the float32 neighbour
        # nearest q where the double rounding picked the other one
        for g in (np.nextafter(f, np.float32(np.inf)),
                  np.nextafter(f, np.float32(-np.inf))):
            if abs(fractions.Fraction(float(g)) - q) < \
                    abs(fractions.Fraction(float(f)) - q):
                f = g
        out.append(np.float32(f + np.float32(1e-10)))
    return np.array(out, np.float32)


@pytest.mark.parametrize("n", [1 << 19, (1 << 19) + 1000])
def test_plain_chunk_power_within_1e6_of_the_exact_mean(n):
    raw = _raw(n, seed=9, jam=(CHUNK, 3 * CHUNK))
    exact = _exact_means(raw, CHUNK)
    plain = power.chunk_power(iq.int8_to_complex(raw), CHUNK).numpy()
    np.testing.assert_allclose(plain, exact, rtol=1e-6, atol=0)


def test_front_raises_off_cpu_and_cuda():
    raw = torch.empty(2 * 1024, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_front.block_front(raw, CHUNK, 5.0, 6.0)
