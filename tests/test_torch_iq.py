"""Port ingest (gps_jamming_tpu_torch.ops.iq) vs the JAX package.

The same seeded bytes go through both; every conversion is exact, so the
tolerance is bit equality unless stated.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_jamming_tpu.ops import iq as jiq
from gps_jamming_tpu_torch.ops import iq as tiq

torch.set_num_threads(2)


def _raw(n_bytes, seed=1):
    return np.random.default_rng(seed).integers(0, 256, n_bytes,
                                                dtype=np.uint8)


@pytest.mark.parametrize("convention", ["centered", "normalized", "int8"])
@pytest.mark.parametrize("n_bytes", [4096, 1000])   # a multiple of 256, not
def test_int8_to_complex_matches_jax(convention, n_bytes):
    x8 = jiq.uint8_np_to_int8(_raw(n_bytes))
    want = jiq.int8_to_planar(jnp.asarray(x8), convention=convention)
    got = tiq.int8_to_complex(torch.from_numpy(x8.copy()),
                              convention=convention)
    assert got.dtype == torch.complex64 and got.shape == (n_bytes // 2,)
    np.testing.assert_array_equal(got.real.numpy(), np.asarray(want.re))
    np.testing.assert_array_equal(got.imag.numpy(), np.asarray(want.im))


def test_int8_to_complex_rejects_bad_input():
    with pytest.raises(ValueError):
        tiq.int8_to_complex(torch.zeros(7, dtype=torch.int8))
    with pytest.raises(ValueError):
        tiq.int8_to_complex(torch.zeros(8, dtype=torch.uint8))
    with pytest.raises(ValueError):
        tiq.int8_to_complex(torch.zeros(8, dtype=torch.int8),
                            convention="raw")


@pytest.mark.parametrize("scale", [None, 127.5])
def test_bytes_to_iq_f32_matches_jax(scale):
    raw = _raw(2048, seed=2)
    want = np.asarray(jiq.bytes_to_iq_f32(jnp.asarray(raw), scale=scale))
    got = tiq.bytes_to_iq_f32(torch.from_numpy(raw), scale=scale)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tiq.uint8_np_to_int8(raw),
                                  jiq.uint8_np_to_int8(raw))


def test_framing_and_dc_match_jax():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(1000)
         + 1j * rng.standard_normal(1000)).astype(np.complex64)
    for frame_len, hop in ((64, 32), (100, 30)):
        want = np.asarray(jiq.frame(jnp.asarray(x), frame_len, hop))
        got = tiq.frame(torch.from_numpy(x), frame_len, hop).numpy()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tiq.frame_nonoverlap(torch.from_numpy(x), 64).numpy(),
        np.asarray(jiq.frame_nonoverlap(jnp.asarray(x), 64)))
    xb = x.reshape(10, 100)
    np.testing.assert_allclose(                  # f32 mean: 1e-6
        tiq.remove_dc(torch.from_numpy(xb)).numpy(),
        np.asarray(jiq.remove_dc(jnp.asarray(xb))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("convention", ["centered", "normalized", "int8"])
def test_file_io_matches_jax(tmp_path, convention):
    raw = _raw(2001, seed=4)                     # odd: the last byte drops
    p = tmp_path / "cap.bin"
    p.write_bytes(raw.tobytes())
    got = tiq.read_iq_file(str(p), convention=convention)
    np.testing.assert_array_equal(
        got, jiq.read_iq_file(str(p), convention=convention))
    if convention == "centered":
        tiq.write_iq_file(str(tmp_path / "t.bin"), got)
        jiq.write_iq_file(str(tmp_path / "j.bin"), got)
        assert (tmp_path / "t.bin").read_bytes() == \
            (tmp_path / "j.bin").read_bytes()


def test_uint8_to_complex_equals_the_centered_file_read(tmp_path):
    """Every (I, Q) byte pair, as a file: `uint8_to_complex` of its bytes
    is `read_iq_file(..., 'centered')` bit for bit (x - 127.5 is exact in
    float32 for every byte), as the sharded path relies on."""
    i, q = np.meshgrid(np.arange(256, dtype=np.uint8),
                       np.arange(256, dtype=np.uint8), indexing="ij")
    raw = np.stack([i.ravel(), q.ravel()], axis=-1).ravel()
    p = tmp_path / "pairs.bin"
    raw.tofile(p)
    want = tiq.read_iq_file(str(p), convention="centered")
    got = tiq.uint8_to_complex(torch.from_numpy(raw)).numpy()
    assert got.dtype == want.dtype == np.complex64
    assert got.shape == want.shape == (65536,)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
