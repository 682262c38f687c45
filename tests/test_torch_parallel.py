"""The port's mesh, halo exchange and sharded pipelines
(gps_jamming_tpu_torch.parallel) vs the JAX package's, on the CPU.

JAX runs its shard_map pipelines on the 8 virtual CPU devices of
tests/conftest.py; the port runs on a mesh of repeated 'cpu' entries, the
same inputs made from a seed with numpy going through both.

- `make_mesh`: shapes and JAX's ValueErrors, message for message.
- `halo_from_next` / `halo_from_prev`: equal to JAX's ppermute halos
  (zeros where there is no source).
- `sharded_psd_and_power` on a 2 x 4 mesh: the PSDs within rtol 2e-4 of
  JAX's (B2's mean x count where JAX sums; float32), the power map rtol
  1e-5; bitwise equal on a second run (the sums' order is fixed).
- `sharded_caf_acquire` 'std' and 'pcf' (8 PRN x 512 lags): rtol 2e-4,
  atol 1e-3 * max; a coherent group that straddles shards raises
  ValueError, as in JAX.
- `sharded_pair_xcorr`: rtol 3e-3 (atol 1e-3), the known delay's peak.
- `shard_blocks`: JAX's layout; a wrong antenna count raises ValueError,
  also under `python -O`.
- the placement helpers round-trip a capture.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from gps_jamming_tpu.config import DetectorConfig as JDet
from gps_jamming_tpu.config import SpectralConfig as JSpec
from gps_jamming_tpu.ops import caf as jcaf
from gps_jamming_tpu.ops import cplx as jcplx
from gps_jamming_tpu.parallel import fusion as jfusion
from gps_jamming_tpu.parallel import halo as jhalo
from gps_jamming_tpu.parallel import mesh as jmesh
from gps_jamming_tpu_torch.config import DetectorConfig, SpectralConfig
from gps_jamming_tpu_torch.ops import caf, codes
from gps_jamming_tpu_torch.parallel import fusion, halo
from gps_jamming_tpu_torch.parallel import mesh as mesh_lib

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 2.048e6
CPU8 = ["cpu"] * 8


def _streams(seed, n_ant, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_ant, n))
            + 1j * rng.standard_normal((n_ant, n))).astype(np.complex64)


@pytest.mark.parametrize("n_ant,n_time,devices,shape", [
    (2, 4, CPU8, {"antenna": 2, "time": 4}),
    (2, None, CPU8, {"antenna": 2, "time": 4}),
    (1, None, CPU8, {"antenna": 1, "time": 8}),
    (3, 2, CPU8[:6], {"antenna": 3, "time": 2})])
def test_make_mesh_shapes(n_ant, n_time, devices, shape):
    m = mesh_lib.make_mesh(n_ant, n_time, devices=devices)
    assert m.shape == shape
    assert m.axis_names == (mesh_lib.ANTENNA_AXIS, mesh_lib.TIME_AXIS)
    assert [len(r) for r in m.devices] == [shape["time"]] * shape["antenna"]
    assert m.devices[0][0] == torch.device("cpu") and not m.distributed
    if devices is CPU8:
        assert m.shape == dict(jmesh.make_mesh(n_ant, n_time).shape)


@pytest.mark.parametrize("n_ant,n_time", [(3, None), (3, 2), (2, 8)])
def test_make_mesh_errors_match_jax(n_ant, n_time):
    with pytest.raises(ValueError) as want:
        jmesh.make_mesh(n_ant, n_time)
    with pytest.raises(ValueError) as got:
        mesh_lib.make_mesh(n_ant, n_time, devices=CPU8)
    assert str(got.value) == str(want.value)


def _jax_halo(fn, h):
    m = jmesh.make_mesh(1, 8)
    x = jnp.arange(64, dtype=jnp.float32).reshape(1, 8, 8)
    f = shard_map(lambda local: fn(local.reshape(local.shape[0], -1), h),
                  mesh=m, in_specs=P("antenna", "time", None),
                  out_specs=P("antenna", "time"))
    return np.asarray(jax.jit(f)(x)).reshape(8, 8 + h)


@pytest.mark.parametrize("which,h", [("next", 3), ("prev", 2)])
def test_halo_matches_jax(which, h):
    m = mesh_lib.make_mesh(1, 8, devices=CPU8)
    x = np.arange(64, dtype=np.float32).reshape(1, 8, 8)
    (row,) = mesh_lib.place_blocks(x, m)
    fn = halo.halo_from_next if which == "next" else halo.halo_from_prev
    got = np.stack([t.reshape(-1).numpy() for t in fn(row, h)])
    want = _jax_halo(jhalo.halo_from_next if which == "next"
                     else jhalo.halo_from_prev, h)
    np.testing.assert_array_equal(got, want)
    edge = got[7, 8:] if which == "next" else got[0, :h]
    np.testing.assert_array_equal(edge, np.zeros(h))


@pytest.fixture(scope="module")
def psd_case():
    det_j, spec_j = JDet(power_chunk_samples=2048), JSpec(nperseg=1024)
    det, spec = DetectorConfig(power_chunk_samples=2048), \
        SpectralConfig(nperseg=1024)
    n_ant, n_time, block = 2, 4, 1 << 14
    streams = _streams(5, n_ant, n_time * block)
    t = np.arange(n_time * block) / FS
    streams[0] += np.exp(2j * np.pi * 200e3 * t).astype(np.complex64)
    blocks = fusion.shard_blocks(streams, n_ant, n_time, block)
    want = [np.asarray(a) for a in jfusion.sharded_psd_and_power(
        jnp.asarray(blocks), jmesh.make_mesh(n_ant, n_time), FS, det_j,
        spec_j)]
    m = mesh_lib.make_mesh(n_ant, n_time, devices=CPU8)
    return blocks, m, det, spec, want


def test_sharded_psd_and_power_matches_jax(psd_case):
    blocks, m, det, spec, (psd_fused, psd_ant, pm) = psd_case
    got = fusion.sharded_psd_and_power(blocks, m, FS, det, spec)
    assert [tuple(g.shape) for g in got] == [(1024,), (2, 1024),
                                            (2, 4 * (1 << 14) // 2048)]
    np.testing.assert_allclose(got[0].numpy(), psd_fused, rtol=2e-4)
    np.testing.assert_allclose(got[1].numpy(), psd_ant, rtol=2e-4)
    np.testing.assert_allclose(got[2].numpy(), pm, rtol=1e-5)
    assert int(np.argmax(got[0].numpy())) == int(np.argmax(psd_fused))


def test_sharded_psd_is_bitwise_repeatable(psd_case):
    blocks, m, det, spec, _ = psd_case
    a = fusion.sharded_psd_and_power(blocks, m, FS, det, spec)
    b = fusion.sharded_psd_and_power(mesh_lib.place_blocks(blocks, m), m,
                                     FS, det, spec)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _caf_case(group_blocks):
    n_code, n_ant, n_time = 512, 2, 4
    block = group_blocks * n_code
    streams = _streams(11, n_ant, n_time * block)
    planes = codes.sampled_code_fft_conj_host(codes.gps_ca_table()[:8],
                                              1.023e6, FS, n_code)
    blocks = fusion.shard_blocks(streams, n_ant, n_time, block)
    return blocks, planes


@pytest.mark.parametrize("method", ["std", "pcf"])
def test_sharded_caf_acquire_matches_jax(method):
    blocks, planes = _caf_case(2)
    freqs = caf.doppler_bins(7000.0, 1000.0)
    kw = dict(method=method, max_doppler_hz=7000.0,
              group_blocks=2) if method == "pcf" else {}
    want = np.asarray(jfusion.sharded_caf_acquire(
        jnp.asarray(blocks), jmesh.make_mesh(2, 4), jcplx.CArray(*planes),
        freqs, FS, **kw))
    got = fusion.sharded_caf_acquire(
        blocks, mesh_lib.make_mesh(2, 4, devices=CPU8), planes, freqs, FS,
        **kw).numpy()
    n_f = freqs.size if method == "std" else \
        jcaf.pcf_doppler_hz(FS, 512, 7000.0).size
    assert got.shape == want.shape == (2, 8, n_f, 512)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-3 * want.max())


def test_sharded_pcf_rejects_straddling_groups():
    planes = codes.sampled_code_fft_conj_host(codes.gps_ca_table()[:4],
                                              1.023e6, FS, 512)
    blk = np.zeros((2, 4, 3 * 512), np.complex64)
    with pytest.raises(ValueError, match="group_blocks") as want:
        jfusion.sharded_caf_acquire(jnp.asarray(blk), jmesh.make_mesh(2, 4),
                                    jcplx.CArray(*planes), None, FS,
                                    method="pcf", group_blocks=2)
    with pytest.raises(ValueError, match="group_blocks") as got:
        fusion.sharded_caf_acquire(blk, mesh_lib.make_mesh(2, 4,
                                                           devices=CPU8),
                                   planes, None, FS, method="pcf",
                                   group_blocks=2)
    assert str(got.value) == str(want.value)


def test_sharded_pair_xcorr_matches_jax():
    L, n_ant = 1024, 4
    base = _streams(3, 1, L + 64)[0]
    slices = np.stack([base[k:k + L] for k in range(n_ant)])
    want = np.asarray(jfusion.sharded_pair_xcorr(jnp.asarray(slices),
                                                 jmesh.make_mesh(n_ant, 2)))
    got = fusion.sharded_pair_xcorr(
        slices, mesh_lib.make_mesh(n_ant, 2, devices=CPU8)).numpy()
    assert got.shape == want.shape == (6, 2 * L)
    np.testing.assert_allclose(got, want, rtol=3e-3, atol=1e-3)
    for k, (i, j) in enumerate([(0, 1), (0, 2), (0, 3), (1, 2), (1, 3),
                                (2, 3)]):
        assert int(np.argmax(got[k])) == (j - i) % (2 * L)


@pytest.mark.parametrize("n,n_time,block_len", [(1000, 4, None),
                                                 (1000, 3, 400),
                                                 (64, 8, 8)])
def test_shard_blocks_matches_jax(n, n_time, block_len):
    x = _streams(2, 2, n)
    got = fusion.shard_blocks(x, 2, n_time, block_len)
    want = jfusion.shard_blocks(x, 2, n_time, block_len)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("optimize", [False, True])
def test_shard_blocks_rejects_a_wrong_antenna_count(optimize):
    code = ("import numpy as np\n"
            "from gps_jamming_tpu_torch.parallel import fusion\n"
            "try:\n"
            "    fusion.shard_blocks(np.zeros((3, 16)), 2, 4)\n"
            "except ValueError as e:\n"
            "    print('ValueError', e)\n")
    r = subprocess.run([sys.executable] + (["-O"] if optimize else [])
                       + ["-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-1500:]
    assert r.stdout.startswith("ValueError shard_blocks: 3 streams"), r.stdout


def test_place_and_gather_blocks_round_trip():
    m = mesh_lib.make_mesh(2, 4, devices=CPU8)
    x = _streams(9, 2, 8 * 16).reshape(2, 8, 16)
    grid = mesh_lib.place_blocks(x, m)
    assert [[tuple(s.shape) for s in r] for r in grid] == [[(2, 16)] * 4] * 2
    np.testing.assert_array_equal(mesh_lib.gather_blocks(grid).numpy(), x)
    assert mesh_lib.place_blocks(grid, m) == grid
    with pytest.raises(ValueError, match="split over 4 time shards"):
        mesh_lib.place_blocks(x[:, :6], m)
    with pytest.raises(ValueError, match="3 rows"):
        mesh_lib.place_blocks(np.zeros((3, 8, 16)), m)
