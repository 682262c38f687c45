"""Port power pre-scan (models.detector) vs the JAX package on the same
seeded capture: the chunk power map within rtol 1e-6 and equal ranges."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_jamming_tpu.config import DetectorConfig as JDetectorConfig
from gps_jamming_tpu.models import detector as jdet
from gps_jamming_tpu.ops import iq as jiq
from gps_jamming_tpu_torch.config import DetectorConfig
from gps_jamming_tpu_torch.models import detector as tdet
from gps_jamming_tpu_torch.ops import iq as tiq

torch.set_num_threads(2)

CFG = DetectorConfig(power_chunk_samples=4096)          # the port's
JCFG = JDetectorConfig(power_chunk_samples=4096)        # the JAX package's


def _capture_bytes(n, seed=31):
    """uint8 I/Q: noise with a +10 dB burst over samples [0.4n, 0.6n)."""
    rng = np.random.default_rng(seed)
    x = 8.0 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    x[int(0.4 * n):int(0.6 * n)] *= np.sqrt(10.0)
    inter = np.empty(2 * n)
    inter[0::2], inter[1::2] = x.real, x.imag
    return (np.clip(inter, -128, 127).astype(np.int16) + 128).astype(np.uint8)


def test_power_profile_matches_jax():
    raw = _capture_bytes(100 * 4096 + 1500)
    xj = jiq.int8_to_planar(jnp.asarray(jiq.uint8_np_to_int8(raw)))
    want = jdet.power_profile(np.asarray(xj.re) + 1j * np.asarray(xj.im),
                              JCFG)
    got = tdet.power_profile(tiq.int8_to_complex(
        torch.from_numpy(tiq.uint8_np_to_int8(raw).copy())), CFG)
    np.testing.assert_allclose(got.power_map.numpy(),
                               np.asarray(want.power_map), rtol=1e-6)
    np.testing.assert_allclose(float(got.threshold), float(want.threshold),
                               rtol=1e-6)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert tdet.power_profile_ranges(got, CFG) == \
        jdet.power_profile_ranges(want, JCFG) != []


@pytest.mark.parametrize("block_chunks,max_samples", [(256, None), (7, None),
                                                      (7, 50 * 4096 + 10)])
def test_power_profile_file_matches_jax(tmp_path, block_chunks, max_samples):
    """Streaming in blocks of `block_chunks` chunks with a partial tail
    chunk, and a capture cut by max_samples."""
    path = tmp_path / "cap.bin"
    _capture_bytes(100 * 4096 + 1500).tofile(path)
    want = jdet.power_profile_file(str(path), JCFG, max_samples=max_samples,
                                   block_chunks=block_chunks)
    got = tdet.power_profile_file(str(path), CFG, max_samples=max_samples,
                                  block_chunks=block_chunks, device="cpu")
    assert got.power_map.shape == np.asarray(want.power_map).shape
    np.testing.assert_allclose(got.power_map.numpy(),
                               np.asarray(want.power_map), rtol=1e-6)
    assert tdet.power_profile_ranges(got, CFG) == \
        jdet.power_profile_ranges(want, JCFG)
    if max_samples is None:
        whole = tdet.power_profile(torch.from_numpy(tiq.read_iq_file(
            str(path), convention="centered")), CFG)
        np.testing.assert_allclose(got.power_map.numpy(),
                                   whole.power_map.numpy(), rtol=1e-6)
