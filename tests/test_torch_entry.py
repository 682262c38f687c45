"""The port's whole slice vs the JAX package's, and the port's guarantees:
no jax on its import path, no CPU stand-in for a missing CUDA kernel.

Slice tolerances (one 1<<16-sample raw block through both forwards): psd
rtol 1e-4, atol 1e-4 * max; pm rtol 1e-6; flags equal; surf rtol 2e-4,
atol 2e-4 * max; the std chain's per-PRN peak rtol 2e-4.
"""
import contextlib
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from gps_jamming_tpu_torch import convert
from gps_jamming_tpu_torch import device as tdevice
from gps_jamming_tpu_torch import entry as tentry
from gps_jamming_tpu_torch.kernels import build

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_slice_forward_matches_jax_entry():
    jfn, (raw,) = __graft_entry__.entry()
    raw = np.array(raw)[: 2 * (1 << 16)]
    want = [np.asarray(a) for a in jax.jit(jfn)(jnp.asarray(raw))]
    tfn, (traw,) = tentry.entry(torch.device("cpu"))
    np.testing.assert_array_equal(traw.numpy(),
                                  np.asarray(__graft_entry__.entry()[1][0]))
    got = [a.numpy() for a in tfn(torch.from_numpy(raw))]
    psd, pm, flags, surf = got
    assert psd.shape == want[0].shape == (1024,)
    assert surf.shape == want[3].shape == (32, 90, 2048)
    np.testing.assert_allclose(psd, want[0], rtol=1e-4,
                               atol=1e-4 * want[0].max())
    np.testing.assert_allclose(pm, want[1], rtol=1e-6)
    np.testing.assert_array_equal(flags, want[2])
    np.testing.assert_allclose(surf, want[3], rtol=2e-4,
                               atol=2e-4 * want[3].max())
    # the measured step reduces the same search to its per-PRN peak
    step = tentry.detect_acquire_step(torch.from_numpy(raw))
    np.testing.assert_allclose(step[0].numpy(), psd, rtol=1e-6)
    np.testing.assert_allclose(step[3].numpy(), surf.max(axis=(1, 2)),
                               rtol=2e-4)


def test_detect_acquire_step_std_matches_jax_chain():
    """detect_acquire_step(method='std') against `bench.py`'s std chain
    body (acq_method='std'), rebuilt from the JAX package's functions, on
    the same raw block and an 8-PRN replica."""
    from gps_jamming_tpu.models.receiver import acquisition as jacq
    from gps_jamming_tpu.ops import caf, cplx, iq, power, spectral
    fs = tentry.FS
    raw = np.array(__graft_entry__.entry()[1][0])[: 2 * (1 << 16)]
    rep = jacq.gps_replica_table_host(fs, 2048)
    rep = cplx.CArray(rep.re[:8], rep.im[:8])

    def block_step(raw_i8):
        x = iq.int8_to_planar(raw_i8)
        psd = spectral.welch_psd_p(x, fs, 1024)
        pm = power.chunk_power_p(x, 32768)
        thr = power.power_threshold_linear(power.power_baseline(pm, 5.0),
                                           6.0)
        blocks = x[: 10 * 2048].reshape(10, 2048)
        surf = caf.caf_accumulate(blocks, rep,
                                  caf.doppler_bins(7000.0, 200.0), fs)
        return psd, pm, pm > thr, jnp.max(surf, axis=(-2, -1))

    want = [np.asarray(a) for a in jax.jit(block_step)(jnp.asarray(raw))]
    got = [a.numpy() for a in tentry.detect_acquire_step(
        torch.from_numpy(raw), convert.replica_from_jax(rep, "cpu"),
        method="std")]
    assert got[3].shape == want[3].shape == (8,)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4,
                               atol=1e-4 * want[0].max())
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[3], want[3], rtol=2e-4)
    with pytest.raises(ValueError):
        tentry.detect_acquire_step(torch.from_numpy(raw), method="fft")


def test_port_imports_no_jax():
    mods = [
        "gps_jamming_tpu_torch", "gps_jamming_tpu_torch.device",
        "gps_jamming_tpu_torch.convert", "gps_jamming_tpu_torch.entry",
        "gps_jamming_tpu_torch.kernels.build",
        "gps_jamming_tpu_torch.ops.iq", "gps_jamming_tpu_torch.ops.codes",
        "gps_jamming_tpu_torch.ops.power",
        "gps_jamming_tpu_torch.ops.spectral",
        "gps_jamming_tpu_torch.ops.cuda_psd",
        "gps_jamming_tpu_torch.ops.cuda_front",
        "gps_jamming_tpu_torch.ops.corr", "gps_jamming_tpu_torch.ops.caf",
        "gps_jamming_tpu_torch.ops.cuda_pcf",
        "gps_jamming_tpu_torch.ops.cuda_caf",
        "gps_jamming_tpu_torch.models.detector",
        "gps_jamming_tpu_torch.models.receiver.acquisition",
        "gps_jamming_tpu_torch.models.receiver.galileo",
        "gps_jamming_tpu_torch.models.receiver.glonass",
    ]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "importlib.import_module('gps_jamming_tpu_torch.models.receiver"
            ".galileo').e1b_code(1)\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'triton']\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_require_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdevice.require_cuda()
    # card first: no device named is the card, so it raises too
    with pytest.raises(RuntimeError, match="CUDA"):
        tdevice.as_device(None)
    assert tdevice.as_device("cpu") == torch.device("cpu")


def test_kernel_loader_raises_without_nvcc():
    if build.find_nvcc() is not None:
        pytest.skip("nvcc is present")
    build.load.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc"):
        build.load()
    assert len(build.source_hash()) == 16


@pytest.mark.parametrize("rc", [0, 700])
def test_launch_passes_the_stream_and_counts(monkeypatch, rc):
    """`build.launch` through a fake library: the device's current stream
    goes last; a zero return counts one launch under the entry's kernel,
    a non-zero one raises RuntimeError naming the entry and counts
    nothing."""
    calls, entered = [], []

    class FakeLib:
        def gjt_pcf_large(self, *args):
            calls.append(args)
            return rc

    class FakeStream:
        cuda_stream = 0xBEEF

    class FakeDevice:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            entered.append(self.device)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(build, "load", FakeLib)
    monkeypatch.setattr(torch.cuda, "device", FakeDevice)
    monkeypatch.setattr(torch.cuda, "current_stream", FakeStream)
    monkeypatch.setattr(torch.cuda, "CudaError", lambda err: f"error {err}")
    monkeypatch.setattr(build, "LAUNCHES", build.LAUNCHES.copy())
    dev = torch.device("cuda", 1)
    before = build.launch_counts()
    if rc:
        with pytest.raises(RuntimeError, match="gjt_pcf_large failed"):
            build.launch("gjt_pcf_large", dev, 11, 22, 33)
    else:
        build.launch("gjt_pcf_large", dev, 11, 22, 33)
    assert calls == [(11, 22, 33, 0xBEEF)] and entered == [dev]
    want = dict(before, pcf=before["pcf"] + (rc == 0))
    assert build.launch_counts() == want


def test_launch_passes_scratch_per_stream(monkeypatch):
    """A `build.Scratch` argument reaches the C entry point as the pointer
    to zeroed scratch of the size its sizer gives, the same buffer again
    on one stream and another buffer on another stream."""
    got, streams = [], [0xA1]

    class FakeLib:
        def gjt_front_scratch_bytes(self):
            return 24

        def gjt_block_front(self, *args):
            got.append(args)
            return 0

    class FakeStream:
        @property
        def cuda_stream(self):
            return streams[-1]

    monkeypatch.setattr(build, "load", FakeLib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", FakeStream)
    monkeypatch.setattr(build, "LAUNCHES", build.LAUNCHES.copy())
    build._scratch.cache_clear()
    cpu = torch.device("cpu")
    spec = build.Scratch("gjt_front_scratch_bytes")
    for stream in (0xA1, 0xA1, 0xB2):
        streams.append(stream)
        build.launch("gjt_block_front", cpu, 1, 2, spec, 3)
    sc_b = build.scratch(spec, cpu)                 # the current stream
    streams.append(0xA1)
    sc_a = build.scratch(spec, cpu)
    assert sc_a.shape == (24,) and sc_a.dtype == torch.uint8
    assert not sc_a.any()
    assert [a[2] for a in got] == [sc_a.data_ptr()] * 2 + [sc_b.data_ptr()]
    assert sc_b.data_ptr() != sc_a.data_ptr()
    assert [a[-1] for a in got] == [0xA1, 0xA1, 0xB2]
    build._scratch.cache_clear()


def test_chip_smoke_fails_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line where
    CUDA is unavailable, and where it stands alone without the package."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd, script in ((REPO, "chip_smoke.py"),
                        (str(tmp_path), shutil.copy(
                            os.path.join(REPO, "chip_smoke.py"), tmp_path))):
        out = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=300,
                             env={**os.environ, "PYTHONPATH": ""})
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
