"""Every public name of the JAX package has its counterpart in the port,
apart from the TPU artifacts and the decided departures listed below, and
the last ones ported hold to the JAX functions on the CPU.

Tolerances: codes, tables, overlays, `uint8_to_int8`, the host replica
planes and the result tuples' fields equal; `circular_correlation_power`
rtol 1e-5 + atol 1e-6 * max, and the device replica spectra
(`sampled_code_fft_conj`, `acquisition.gps_replica_table`) rtol 1e-5 +
atol 1e-6 * max: pocketfft (torch) and XLA's CPU FFT round float32 apart
by up to 1.7e-7 of the largest value, which near a zero of the power or
the spectrum is more than 1e-5 of the value itself.
"""
import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_jamming_tpu.models import tdoa as jtdoa
from gps_jamming_tpu.models.receiver import acquisition as jacq
from gps_jamming_tpu.models.receiver import tracking as jtracking
from gps_jamming_tpu.ops import codes as jcodes
from gps_jamming_tpu.ops import corr as jcorr
from gps_jamming_tpu.ops import iq as jiq
from gps_jamming_tpu.ops import power as jpower
from gps_jamming_tpu_torch.models import tdoa
from gps_jamming_tpu_torch.models.receiver import acquisition, tracking
from gps_jamming_tpu_torch.ops import codes, corr, iq, power

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Modules and names of the JAX package that exist only to work around the
# TPU runtime (no complex dtype, no FFT HLO, no uint8; Pallas and its
# layouts; XLA shardings and tracing), each beside what the port has in
# its place.
TPU_MODULES = {
    "ops/cplx.py": "complex64 tensors",
    "ops/fftcore.py": "torch.fft",
    "ops/pallas_psd.py": "ops/cuda_psd.py, kernels/gates.py",
    "ops/pallas_caf.py": "ops/cuda_pcf.py, ops/cuda_caf.py, "
                         "kernels/gates.py",
}
TPU_NAMES = {
    "ops/__init__.py": {"set_compute_precision"},
    "ops/caf.py": {"ACQ_FUSED_PRECISION", "fused_dispatch",
                   "resolve_acq_precision", "set_acq_precision"},
    "ops/corr.py": {"xcorr_full_p"},
    "ops/iq.py": {"int8_interleaved_to_complex", "int8_to_planar"},
    "ops/power.py": {"chunk_power_p"},
    "ops/spectral.py": {"PSD_FUSED", "spectrogram_p", "welch_psd_p"},
    "parallel/mesh.py": {"antenna_sharding", "capture_sharding",
                         "replicated"},
    "models/receiver/acquisition.py": {"acquire_all_jit"},
    "models/receiver/tracking.py": {"resample_base_table_jnp"},
    "runtime/profiling.py": {"xla_trace"},
}

# Names the port replaced by a decided departure (ROADMAP §C), each beside
# what the port has in its place.
DEPARTED = {
    "runtime/sharded.py": {
        "SLICE_LEN": "config.TdoaConfig.correlation_slice_size (C18)"},
}


def _public_names(path: str) -> set[str]:
    tree = ast.parse(open(path).read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


def test_every_public_name_of_the_jax_package_is_ported():
    jax_root = os.path.join(REPO, "gps_jamming_tpu")
    missing = {}
    for root, _, files in os.walk(jax_root):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(root, f), jax_root)
            if rel in TPU_MODULES:
                continue
            port = os.path.join(REPO, "gps_jamming_tpu_torch", rel)
            want = _public_names(os.path.join(root, f))
            got = _public_names(port) if os.path.exists(port) else set()
            left = want - got - TPU_NAMES.get(rel, set()) \
                - set(DEPARTED.get(rel, {}))
            if left:
                missing[rel] = sorted(left)
    assert not missing, missing
    # the TPU names listed are still the JAX package's (no stale entry)
    for rel, names in TPU_NAMES.items():
        assert names <= _public_names(os.path.join(jax_root, rel)), rel
    # a departed name is still the JAX package's, and gone from the port
    for rel, names in DEPARTED.items():
        assert set(names) <= _public_names(os.path.join(jax_root, rel)), rel
        assert not set(names) & _public_names(
            os.path.join(REPO, "gps_jamming_tpu_torch", rel)), rel
    for rel in TPU_MODULES:
        assert os.path.exists(os.path.join(jax_root, rel)), rel


def test_l1c_tables_and_codes_equal_the_jax_packages():
    for name in ("_L1CP_WEIL", "_L1CP_INSERT", "_L1CD_WEIL", "_L1CD_INSERT",
                 "_WEIL_P", "_L1C_LEN"):
        assert getattr(codes, name) == getattr(jcodes, name), name
    np.testing.assert_array_equal(codes._L1C_EXPANSION,
                                  jcodes._L1C_EXPANSION)
    np.testing.assert_array_equal(codes.legendre_10223(),
                                  jcodes.legendre_10223())
    for prn in range(1, 64):
        for got, want in ((codes.gps_l1cp_code, jcodes.gps_l1cp_code),
                          (codes.gps_l1cd_code, jcodes.gps_l1cd_code)):
            g, w = got(prn), want(prn)
            assert g.dtype == w.dtype == np.int8
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(codes.weil_code(1234, 10224),
                                  jcodes.weil_code(1234, 10224))
    np.testing.assert_array_equal(codes.nh10(), jcodes.nh10())
    np.testing.assert_array_equal(codes.nh20(), jcodes.nh20())
    for gen in (codes.gps_l1cp_code, codes.gps_l1cd_code):
        for prn in (0, 64):
            with pytest.raises(ValueError, match="PRN"):
                gen(prn)
    with pytest.raises(ValueError, match="insertion point"):
        codes.weil_code(5111, 0)


def test_legendre_properties():
    L = codes.legendre_10223()
    assert L.size == 10223 and L[0] == 0
    # exactly (p-1)/2 quadratic residues
    assert int(L.sum()) == (10223 - 1) // 2
    # multiplicativity spot check: QR*QR=QR, QR*NQR=NQR
    qr = np.where(L == 1)[0][1:50]
    nqr = np.where(L == 0)[0][1:50]
    assert L[(qr[0] * qr[1]) % 10223] == 1
    assert L[(qr[0] * nqr[1]) % 10223] == 0


def test_l1c_weil_codes():
    for gen in (codes.gps_l1cp_code, codes.gps_l1cd_code):
        c1 = gen(1)
        c2 = gen(2)
        assert c1.size == 10230
        assert set(np.unique(c1)) <= {-1, 1}
        # near-balanced, distinct PRNs nearly orthogonal
        assert abs(int(c1.sum())) < 300
        assert abs(int((c1 * c2).sum())) < 600
        # sharp autocorrelation: off-peak < 10% of peak
        f = np.fft.fft(c1)
        ac = np.real(np.fft.ifft(f * np.conj(f)))
        assert np.isclose(ac[0], 10230)
        assert np.abs(ac[1:]).max() < 1023
    # pilot and data codes of the same PRN differ
    assert not np.array_equal(codes.gps_l1cp_code(3), codes.gps_l1cd_code(3))


def test_nh_overlays():
    assert np.array_equal(codes.nh10()[:4], [1, 1, 1, 1])
    assert codes.nh10().size == 10 and codes.nh20().size == 20
    assert int(codes.nh20().sum()) == 20 - 2 * 8   # eight 1-bits


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("n", [2048, 2400])
def test_sampled_code_fft_conj_matches_jax(n):
    tab = jcodes.gps_ca_table()[:8]
    want = np.asarray(jcodes.sampled_code_fft_conj(tab, 1.023e6, 2.048e6,
                                                   n))
    got = codes.sampled_code_fft_conj(tab, 1.023e6, 2.048e6, n,
                                      device="cpu")
    assert got.dtype == torch.complex64 and got.device.type == "cpu"
    _close(got.numpy(), want)
    # a tensor keeps its device, whatever `device` says
    again = codes.sampled_code_fft_conj(torch.from_numpy(tab), 1.023e6,
                                        2.048e6, n, device="meta")
    assert again.device.type == "cpu"
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_sampled_code_fft_conj_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        codes.sampled_code_fft_conj(codes.gps_ca_table()[:2], 1.023e6,
                                    2.048e6, 2048)


def test_gps_replica_tables_match_jax():
    want = jacq.gps_replica_table_host(2.048e6, 2048)
    re, im = acquisition.gps_replica_table_host(2.048e6, 2048)
    np.testing.assert_array_equal(re, np.asarray(want.re))
    np.testing.assert_array_equal(im, np.asarray(want.im))
    dev = np.asarray(jacq.gps_replica_table(2.048e6, 2048))
    got = acquisition.gps_replica_table(2.048e6, 2048, "cpu")
    assert tuple(got.shape) == dev.shape == (32, 2048)
    _close(got.numpy(), dev)


def test_circular_correlation_power_matches_jax():
    rng = np.random.default_rng(44)
    n = 2048
    x = (rng.standard_normal((4, n))
         + 1j * rng.standard_normal((4, n))).astype(np.complex64)
    c = rng.choice([-1.0, 1.0], size=(4, n)).astype(np.float32)
    rf = np.conj(np.fft.fft(c)).astype(np.complex64)
    want = np.asarray(jcorr.circular_correlation_power(jnp.asarray(x),
                                                       jnp.asarray(rf)))
    got = corr.circular_correlation_power(torch.from_numpy(x),
                                          torch.from_numpy(rf))
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, n)
    _close(got.numpy(), want)


def test_uint8_to_int8_is_bitwise_the_jax_packages():
    raw = np.tile(np.arange(256, dtype=np.uint8), 3)
    want = np.asarray(jiq.uint8_to_int8(jnp.asarray(raw)))
    got = iq.uint8_to_int8(torch.from_numpy(raw))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), iq.uint8_np_to_int8(raw))


def test_result_tuples_and_streaming_init_match_jax():
    assert tdoa.PairTdoa._fields == jtdoa.PairTdoa._fields
    assert tracking.LoopCoeffs._fields == jtracking.LoopCoeffs._fields
    p = tdoa.PairTdoa((0, 1), 2.5, 1e-6, 300.0, 9.0)
    assert tuple(p) == tuple(jtdoa.PairTdoa((0, 1), 2.5, 1e-6, 300.0, 9.0))
    c1, c2 = tracking.loop_coeffs(18.0, 0.707, 1e-3)
    assert tuple(tracking.LoopCoeffs(c1, c2)) == tuple(
        jtracking.loop_coeffs(18.0, 0.707, 1e-3))
    assert power.chunk_power_streaming_init(32768) == \
        jpower.chunk_power_streaming_init(32768) == ()
