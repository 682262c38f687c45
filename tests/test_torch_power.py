"""Port chunk power and thresholds (gps_jamming_tpu_torch.ops.power) vs the
JAX package on the same seeded captures; rtol 1e-6 (float32 means)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_jamming_tpu.ops import iq as jiq
from gps_jamming_tpu.ops import power as jpower
from gps_jamming_tpu_torch.ops import power as tpower

torch.set_num_threads(2)


def _capture(n, seed=5):
    raw = np.random.default_rng(seed).integers(0, 256, 2 * n, dtype=np.uint8)
    return np.array(jiq.uint8_to_complex(jnp.asarray(raw)))


@pytest.mark.parametrize("n", [3 * 32768 + 1000, 4 * 32768, 20000])
def test_chunk_power_matches_jax(n):
    """Full chunks, a partial tail chunk, and a capture shorter than one
    chunk; the +1e-10 floor included."""
    x = _capture(n)
    want = np.asarray(jpower.chunk_power(jnp.asarray(x), 32768))
    got = tpower.chunk_power(torch.from_numpy(x), 32768).numpy()
    assert got.shape == want.shape == (-(-n // 32768),)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_baseline_threshold_mask_match_jax():
    rng = np.random.default_rng(6)
    pm = rng.uniform(10, 20, size=200).astype(np.float32)
    pm[50:60] = 500.0
    base_j = jpower.power_baseline(jnp.asarray(pm), 5.0)
    base_t = tpower.power_baseline(torch.from_numpy(pm), 5.0)
    np.testing.assert_allclose(float(base_t), float(base_j), rtol=1e-6)
    thr_j = jpower.power_threshold_linear(base_j, 6.0)
    thr_t = tpower.power_threshold_linear(base_t, 6.0)
    np.testing.assert_allclose(float(thr_t), float(thr_j), rtol=1e-6)
    np.testing.assert_array_equal(
        tpower.above_threshold_mask(torch.from_numpy(pm), thr_t).numpy(),
        np.asarray(jpower.above_threshold_mask(jnp.asarray(pm), thr_j)))


def test_baseline_clamps_non_positive():
    z = np.zeros(16, np.float32)
    assert float(tpower.power_baseline(torch.from_numpy(z))) == \
        float(jpower.power_baseline(jnp.asarray(z))) == 1.0


def test_extract_ranges_matches_jax():
    rng = np.random.default_rng(7)
    for _ in range(20):
        mask = rng.random(rng.integers(1, 40)) > 0.5
        assert tpower.extract_ranges(torch.from_numpy(mask), 65536) == \
            jpower.extract_ranges(mask, 65536)
    assert tpower.extract_ranges(np.zeros(5, bool), 10) == []
