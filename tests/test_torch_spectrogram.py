"""The port's spectrogram family and iq additions vs the JAX package.

`spectrogram`, `spectrogram_file`, `freq_axis_mhz`, `mean_spectrum_db`
(ops/spectral.py) and `uint8_to_complex`, `uint8_to_complex_normalized`,
`pad_to_multiple` (ops/iq.py), each on the same numpy inputs as the JAX
function. Tolerances: the spectrogram in dB atol 1e-3 (the Welch PSD's
rtol 1e-4 of tests/test_torch_spectral.py is 4.3e-4 dB), its mean the same;
the ingest and the padding exactly. `spectrogram_file` gives the same rows,
bit for bit, at every batch size and equals `spectrogram` of the whole
capture (each chunk is computed alone).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_jamming_tpu.ops import cplx
from gps_jamming_tpu.ops import iq as jiq
from gps_jamming_tpu.ops import spectral as jspec
from gps_jamming_tpu_torch.ops import iq as tiq
from gps_jamming_tpu_torch.ops import spectral as tspec

torch.set_num_threads(2)

FS = 2.048e6
DB_ATOL = 1e-3


def _tone_capture(n, seed, tone_hz=300e3, amp=20.0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 4.0
    x = x + amp * np.exp(2j * np.pi * tone_hz * t) + (3.0 - 2.0j)
    return x.astype(np.complex64)


@pytest.mark.parametrize("n,chunk,nperseg", [(5 * 8192 + 77, 8192, 1024),
                                             (3 * 6000, 6000, 256),
                                             (4 * 4096, 4096, 1536)])
def test_spectrogram_matches_jax(n, chunk, nperseg):
    x = _tone_capture(n, seed=n)
    want = np.asarray(jspec.spectrogram(jnp.asarray(x), FS, chunk, nperseg))
    got = tspec.spectrogram(torch.from_numpy(x), FS, chunk, nperseg).numpy()
    assert got.shape == want.shape == (n // chunk, nperseg)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=DB_ATOL, rtol=0)


def test_spectrogram_batches_leading_dims():
    x = np.stack([_tone_capture(4 * 4096, seed=s) for s in (1, 2)])
    want = np.stack([np.asarray(jspec.spectrogram(jnp.asarray(r), FS, 4096,
                                                  512)) for r in x])
    got = tspec.spectrogram(torch.from_numpy(x), FS, 4096, 512).numpy()
    assert got.shape == (2, 4, 512)
    np.testing.assert_allclose(got, want, atol=DB_ATOL, rtol=0)


def _write_capture(path, n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    x = rng.standard_normal(n) * 6 + 1j * rng.standard_normal(n) * 6
    x = x + 30.0 * np.exp(2j * np.pi * -250e3 * t)
    jiq.write_iq_file(str(path), x.astype(np.complex64))
    return str(path)


def test_spectrogram_file_matches_jax(tmp_path):
    path = _write_capture(tmp_path / "cap.bin", 7 * 8192 + 300, seed=3)
    want = np.asarray(jspec.spectrogram_file(path, FS, 8192, 1024,
                                             batch_chunks=3))
    got = tspec.spectrogram_file(path, FS, 8192, 1024, batch_chunks=3,
                                 device="cpu")
    assert isinstance(got, np.ndarray) and got.shape == (7, 1024)
    np.testing.assert_allclose(got, want, atol=DB_ATOL, rtol=0)
    capped = tspec.spectrogram_file(path, FS, 8192, 1024,
                                    max_samples=3 * 8192 + 5, device="cpu")
    np.testing.assert_array_equal(capped, got[:3])


def test_spectrogram_file_rows_do_not_depend_on_the_batch(tmp_path):
    path = _write_capture(tmp_path / "cap.bin", 17 * 4096 + 11, seed=4)
    rows = {b: tspec.spectrogram_file(path, FS, 4096, 512, batch_chunks=b,
                                      device="cpu") for b in (1, 3, 16)}
    assert rows[1].shape == (17, 512)
    np.testing.assert_array_equal(rows[1], rows[3])
    np.testing.assert_array_equal(rows[1], rows[16])
    x = tiq.read_iq_file(path, convention="normalized")
    whole = tspec.spectrogram(torch.from_numpy(x), FS, 4096, 512).numpy()
    np.testing.assert_array_equal(rows[16], whole)


def test_spectrogram_file_short_capture(tmp_path):
    path = _write_capture(tmp_path / "short.bin", 1000, seed=5)
    got = tspec.spectrogram_file(path, FS, 4096, 512, device="cpu")
    assert got.shape == (0, 512) and got.dtype == np.float32


def test_spectrogram_file_defaults_to_the_card(tmp_path, monkeypatch):
    path = _write_capture(tmp_path / "cap.bin", 2 * 4096, seed=6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tspec.spectrogram_file(path, FS, 4096, 512)


def test_freq_axis_and_mean_spectrum():
    np.testing.assert_array_equal(tspec.freq_axis_mhz(FS, 1024),
                                  jspec.freq_axis_mhz(FS, 1024))
    np.testing.assert_array_equal(tspec.freq_axis_mhz(10e6, 384),
                                  jspec.freq_axis_mhz(10e6, 384))
    x = _tone_capture(6 * 4096, seed=9)
    sg_j = jspec.spectrogram(jnp.asarray(x), FS, 4096, 512)
    sg_t = tspec.spectrogram(torch.from_numpy(x), FS, 4096, 512)
    want = np.asarray(jspec.mean_spectrum_db(sg_j))
    got = tspec.mean_spectrum_db(sg_t)
    assert isinstance(got, torch.Tensor) and got.shape == (512,)
    np.testing.assert_allclose(got.numpy(), want, atol=DB_ATOL, rtol=0)
    got_np = tspec.mean_spectrum_db(np.asarray(sg_j))
    assert isinstance(got_np, np.ndarray)
    np.testing.assert_allclose(got_np, want, rtol=1e-6)
    # the tone's bin: +300 kHz of a shifted axis
    f = tspec.freq_axis_mhz(FS, 512)
    assert abs(f[int(np.argmax(got_np))] - 0.3) < 2 * FS / 512 / 1e6


def test_uint8_ingest_matches_jax():
    raw = np.random.default_rng(1).integers(0, 256, (3, 2 * 1000),
                                            dtype=np.uint8)
    for tf, jf in ((tiq.uint8_to_complex, jiq.uint8_to_complex),
                   (tiq.uint8_to_complex_normalized,
                    jiq.uint8_to_complex_normalized)):
        got = tf(torch.from_numpy(raw))
        want = np.asarray(jf(jnp.asarray(raw)))
        assert got.dtype == torch.complex64 and got.shape == (3, 1000)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,multiple,dim", [(10, 4, -1), (12, 4, -1),
                                            (5, 8, 0), (7, 3, 1)])
def test_pad_to_multiple_matches_jax(n, multiple, dim):
    shape = (n, 3) if dim == 0 else (2, n)
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape) + 1.0
    want = np.asarray(jiq.pad_to_multiple(jnp.asarray(x), multiple,
                                          axis=dim, value=-2.0))
    got = tiq.pad_to_multiple(torch.from_numpy(x), multiple, dim=dim,
                              value=-2.0).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    xc = (x + 1j * x).astype(np.complex64)
    want_c = np.asarray(jiq.pad_to_multiple(jnp.asarray(xc), multiple,
                                            axis=dim))
    got_c = tiq.pad_to_multiple(torch.from_numpy(xc), multiple,
                                dim=dim).numpy()
    np.testing.assert_array_equal(got_c, want_c)


def test_welch_psd_rows_on_the_cpu_match_jax():
    """A 2-D input on the CPU takes the plain version, row by row equal
    to the JAX package's batched Welch."""
    x = np.stack([_tone_capture(20000, seed=s) for s in (11, 12, 13)])
    want = np.asarray(jspec.welch_psd_p(cplx.asarray(jnp.asarray(x)), FS,
                                        1024))
    got = tspec.welch_psd(torch.from_numpy(x), FS, 1024).numpy()
    assert got.shape == (3, 1024)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * want.max())
