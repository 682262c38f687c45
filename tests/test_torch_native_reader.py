"""The port's native capture reader (native/) and the streaming receiver's
wire formats vs the JAX package, on the CPU.

- `capture_reader.cpp` is a byte-for-byte copy of the JAX package's; it
  builds into `gps_jamming_tpu_torch/_build/`.
- The reader's blocks and halos (native and NumPy) equal the JAX reader's
  exactly; the tail block and a missing file behave as there.
- `quantpack` equals its NumPy twin and the JAX package's C++ pack
  exactly, at every width; it raises ValueError on a bad input, also
  under `python -O`, where the JAX package's `assert` is stripped.
- `StreamingReceiver._ingest` in i8 (each convention), i4, i2 and i1 over
  all 256 byte values equals the JAX function's exactly; host pack ->
  unpack round-trips to the quantized levels; wire_bits='auto' resolves
  to 2 at 10 MS/s and to 8 at 2.048 MS/s; a window that a packed width
  does not divide raises ValueError.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_jamming_tpu.native import reader as jreader
from gps_jamming_tpu.ops import cplx
from gps_jamming_tpu.runtime import rx_stream as jrs
from gps_jamming_tpu_torch.native import reader as treader
from gps_jamming_tpu_torch.runtime import rx_stream as trs

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 1.024e6


@pytest.fixture(scope="module")
def capture_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("native") / "cap.bin"
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, 2 * 10_000 + 2 * 321, dtype=np.uint8)
    raw.tofile(str(p))
    return str(p), raw


def test_source_is_the_jax_packages_and_builds_into_the_port():
    with open(treader.SOURCE, "rb") as a, open(os.path.join(
            REPO, "gps_jamming_tpu", "native", "capture_reader.cpp"),
            "rb") as b:
        assert a.read() == b.read()
    assert treader.native_available(), treader.build_error()
    so = treader.library_path()
    assert so.exists()
    assert so.parent == treader.BUILD_DIR
    assert so.parent.parent.name == "gps_jamming_tpu_torch"


@pytest.mark.parametrize("force_numpy", [False, True])
@pytest.mark.parametrize("block,halo", [(4096, 64), (3000, 0), (512, 700)])
def test_reader_blocks_and_halos_match_jax(capture_file, force_numpy, block,
                                           halo):
    path, _ = capture_file
    with jreader.CaptureReader(path, block, halo,
                               force_numpy=force_numpy) as r:
        want = list(r)
    with treader.CaptureReader(path, block, halo,
                               force_numpy=force_numpy) as r:
        assert r.using_native == (not force_numpy)
        got = list(r)
    assert [o for o, _ in got] == [o for o, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.dtype == np.int8
        np.testing.assert_array_equal(g, w)


def test_reader_tail_block_and_missing_file(capture_file):
    path, raw = capture_file
    with treader.CaptureReader(path, 4096, 0) as r:
        sizes = [b.shape[1] for _, b in r]
    assert sum(sizes) == raw.size // 2
    assert sizes[-1] == (raw.size // 2) % 4096
    for force in (False, True):
        with pytest.raises(FileNotFoundError):
            treader.CaptureReader("/nonexistent/file.bin", 1024,
                                  force_numpy=force)


def _lut(bits, level=3.0):
    vals = np.arange(256).astype(np.int8).astype(np.float32) + 0.5
    if bits == 4:
        return np.clip(np.round(vals / level), -8, 7).astype(np.int8)
    lo = -2 if bits == 2 else -1
    return np.clip(np.floor(vals / (8.0 * level)), lo, lo + 3 if bits == 2
                   else 0).astype(np.int8)


@pytest.mark.parametrize("bits", [4, 2, 1])
def test_quantpack_matches_numpy_and_jax(bits):
    rng = np.random.default_rng(7)
    w = rng.integers(-128, 128, (2, 1 << 12), dtype=np.int8)
    lut = _lut(bits)
    got = treader.quantpack(w, lut, bits)
    assert got.shape == (2, (1 << 12) * bits // 8) and got.dtype == np.int8
    np.testing.assert_array_equal(got, treader.quantpack_numpy(w, lut, bits))
    np.testing.assert_array_equal(got, jreader.quantpack(w, lut, bits))


BAD_INPUTS = {
    "dtype": (lambda w: w.astype(np.int16), 4),
    "non_contiguous": (lambda w: w[:, ::2], 4),
    "one_d": (lambda w: w[0], 4),
    "bits": (lambda w: w, 3),
    "width": (lambda w: w[:, :1001].copy(), 2),
}


@pytest.mark.parametrize("case", list(BAD_INPUTS))
def test_quantpack_rejects_bad_input(case):
    make, bits = BAD_INPUTS[case]
    w = np.zeros((2, 2048), np.int8)
    with pytest.raises(ValueError, match="quantpack"):
        treader.quantpack(make(w), _lut(4), bits)
    with pytest.raises(ValueError, match="lut"):
        treader.quantpack(w, np.zeros(16, np.int8), 4)


def test_quantpack_raises_under_optimize():
    """The checks are not asserts: `python -O` keeps them."""
    code = ("import numpy as np\n"
            "from gps_jamming_tpu_torch.native import reader\n"
            "assert False, 'asserts are on'\n")
    r = subprocess.run([sys.executable, "-O", "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    code = ("import numpy as np\n"
            "from gps_jamming_tpu_torch.native import reader\n"
            "w = np.zeros((2, 64), np.int16)\n"
            "try:\n"
            "    reader.quantpack(w, np.zeros(256, np.int8), 4)\n"
            "except ValueError as e:\n"
            "    print('ValueError', e)\n")
    r = subprocess.run([sys.executable, "-O", "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ValueError quantpack"), r.stdout


# --- wire formats ------------------------------------------------------------

CONVS = {
    "i8_centered": ("i8", np.float32(0.5), np.float32(1.0)),
    "i8_int8": ("i8", np.float32(0.0), np.float32(1.0)),
    "i8_normalized": ("i8", np.float32(0.5), np.float32(1.0 / 127.5)),
    "i4": ("i4", np.float32(3.25)),
    "i2": ("i2", np.float32(12.0)),
    "i1": ("i1", np.float32(20.0)),
}


def _pair():
    return (trs.StreamingReceiver(FS, system="gps", n_slots=2,
                                  segment_s=0.25, device="cpu"),
            jrs.StreamingReceiver(FS, system="gps", n_slots=2,
                                  segment_s=0.25))


@pytest.mark.parametrize("conv", list(CONVS))
def test_ingest_matches_jax_for_every_byte(conv):
    trx, jrx = _pair()
    trx._ingest_conv = jrx._ingest_conv = CONVS[conv]
    b = np.arange(256, dtype=np.uint8).view(np.int8)
    planes = np.stack([b, b[::-1]])                    # (2, 256)
    got = trx._ingest(torch.from_numpy(planes.copy()))
    want = jrx._ingest(cplx.CArray(jnp.asarray(planes[0]),
                                   jnp.asarray(planes[1])))
    assert got.dtype == torch.complex64
    np.testing.assert_array_equal(got.real.numpy(), np.asarray(want.re))
    np.testing.assert_array_equal(got.imag.numpy(), np.asarray(want.im))
    x = torch.ones(8, dtype=torch.complex64)
    assert trx._ingest(x) is x                        # complex passes


@pytest.mark.parametrize("bits", [4, 2, 1])
def test_wire_pack_unpack_roundtrip(bits):
    trx, _ = _pair()
    level = 4.0
    kind = {4: "i4", 2: "i2", 1: "i1"}[bits]
    trx._ingest_conv = (kind, np.float32(level))
    rng = np.random.default_rng(3)
    v = rng.integers(-128, 128, (2, 4096), dtype=np.int8)
    lut = _lut(bits, level)
    q = lut[v.view(np.uint8)].astype(np.float32)
    want = q * level if bits == 4 else (2.0 * q + 1.0) * level
    out = trx._ingest(torch.from_numpy(treader.quantpack(v, lut, bits)))
    np.testing.assert_array_equal(out.real.numpy(), want[0])
    np.testing.assert_array_equal(out.imag.numpy(), want[1])


@pytest.fixture(scope="module")
def noise_bin(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("wire") / "noise.bin")
    np.random.default_rng(8).integers(0, 256, 1 << 16,
                                      dtype=np.uint8).tofile(path)
    return path


@pytest.mark.parametrize("fs,system,want", [(2.048e6, "gps", "i8"),
                                            (10e6, "glonass", "i2")])
def test_wire_auto_resolution(noise_bin, fs, system, want):
    rx = trs.StreamingReceiver(fs, system=system, n_slots=2, segment_s=0.25,
                               device="cpu")
    res = rx.process_file(noise_bin, wire_bits="auto", max_segments=0)
    assert rx._ingest_conv[0] == want
    assert res.cn0_epochs.size == 0 and res.tracked_spans == []


@pytest.mark.parametrize("bits", [4, 2, 1])
def test_wire_window_divisibility(noise_bin, bits):
    """At 1.026 MS/s and 0.251 s the window is (251 + 2) x 1026 = 259578
    samples: divisible by 2, not by 4."""
    rx = trs.StreamingReceiver(1.026e6, system="gps", n_slots=2,
                               segment_s=0.251, device="cpu")
    assert rx.segment_window_samples() == 259578
    if bits == 4:
        rx.process_file(noise_bin, wire_bits=bits, max_segments=0)
        assert rx._ingest_conv[0] == "i4"
    else:
        with pytest.raises(ValueError, match="divisible"):
            rx.process_file(noise_bin, wire_bits=bits, max_segments=0)
    with pytest.raises(ValueError, match="wire_bits"):
        rx.process_file(noise_bin, wire_bits=3, max_segments=0)
