"""Two-process bring-up of the port's multi-device path
(gps_jamming_tpu_torch.parallel.mesh), on the CPU.

Two OS processes join through `mesh.init_distributed` (a file store
under the test's tmp_path, so no loopback port is picked and raced for by
parallel test workers; gloo), build the ('antenna', 'time') = (2, 4) mesh with
`multihost_mesh` (each process one antenna row of 4 CPU time shards) and
run `fusion.sharded_psd_and_power` on their own antenna's stream: the
antenna fusion crosses the process boundary through
`torch.distributed.all_gather`. Both processes' fused PSDs are equal
bitwise, and process 0's equals the mean of the JAX package's
`spectral.welch_psd` of the two streams (rtol 2e-4); the power map equals
the JAX package's `chunk_power` (rtol 1e-5). The workers import no JAX,
and each writes its result to a file: stdout is not parsed, since a
collective library's own log lines may land inside a long printed line.
The rendezvous and the workers have timeouts of their own, so a group that
never forms fails the test instead of hanging the suite.

Single-process cases: `multihost_mesh` without a group is the one
process's mesh; `init_distributed` is a no-op without a coordinator, as
the JAX package's (tests/test_profiling.py); given one, it needs the
process count and rank.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gps_jamming_tpu.ops import power as jpower
from gps_jamming_tpu.ops import spectral as jspectral
from gps_jamming_tpu_torch.parallel import mesh as mesh_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120

WORKER = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, %(repo)r)
torch.set_num_threads(1)

pid, coord, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]

import torch.distributed as dist
from gps_jamming_tpu_torch.config import DetectorConfig, SpectralConfig
from gps_jamming_tpu_torch.parallel import fusion, mesh as mesh_lib

ok = mesh_lib.init_distributed(coordinator_address=coord, num_processes=2,
                               process_id=pid, timeout_s=%(timeout)d)
assert ok, "init_distributed returned False"
assert mesh_lib.init_distributed(coordinator_address=coord,
                                 num_processes=2, process_id=pid) is False
assert dist.get_world_size() == 2

m = mesh_lib.multihost_mesh(n_antenna=2, devices=["cpu"] * 4)
assert m.shape == {"antenna": 2, "time": 4}, m.shape
assert m.local_rows == (pid,) and m.distributed

rng = np.random.default_rng(7)            # SAME streams in both processes
streams = (rng.standard_normal((2, 4 * 4096))
           + 1j * rng.standard_normal((2, 4 * 4096))).astype(np.complex64)
blocks = fusion.shard_blocks(streams, 2, 4, 4096)
psd, psd_ant, pm = fusion.sharded_psd_and_power(
    blocks[pid:pid + 1], m, 2.048e6, DetectorConfig(power_chunk_samples=512),
    SpectralConfig(nperseg=256))
assert tuple(psd_ant.shape) == (2, 256) and tuple(pm.shape) == (2, 32)
with open(out_path, "w") as f:
    json.dump({"psd": psd.numpy().view(np.uint32).tolist(),
               "pm": pm.numpy().tolist()}, f)
dist.destroy_process_group()
"""


def test_two_process_fusion_matches_jax(tmp_path):
    store = f"file://{tmp_path / 'store'}"
    out_paths = [tmp_path / f"result{pid}.json" for pid in (0, 1)]
    env = dict(os.environ)
    env.pop("JAX_COORDINATOR_ADDRESS", None)
    env["GLOO_SOCKET_IFNAME"] = "lo"
    code = WORKER % {"repo": REPO, "timeout": TIMEOUT_S}
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(pid), store, str(out_paths[pid])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S + 60)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("multihost workers timed out")
    results = []
    for (rc, out, err), path in zip(outs, out_paths):
        assert rc == 0, err[-1500:]
        results.append(json.loads(path.read_text()))
    assert results[0] == results[1]
    got = np.asarray(results[0]["psd"], np.uint32).view(np.float32)

    rng = np.random.default_rng(7)
    streams = (rng.standard_normal((2, 4 * 4096))
               + 1j * rng.standard_normal((2, 4 * 4096))
               ).astype(np.complex64)
    want = np.mean([np.asarray(jspectral.welch_psd(jnp.asarray(s), 2.048e6,
                                                   256))
                    for s in streams], axis=0)
    np.testing.assert_allclose(got, want, rtol=2e-4)
    want_pm = np.stack([np.asarray(jpower.chunk_power(jnp.asarray(s), 512))
                        for s in streams])
    np.testing.assert_allclose(results[0]["pm"], want_pm, rtol=1e-5)


def test_multihost_mesh_single_process():
    m = mesh_lib.multihost_mesh(devices=["cpu"] * 8)
    assert m.axis_names == (mesh_lib.ANTENNA_AXIS, mesh_lib.TIME_AXIS)
    assert m.shape == {"antenna": 1, "time": 8}
    assert m.local_rows == (0,) and not m.distributed
    with pytest.raises(ValueError, match="not divisible"):
        mesh_lib.multihost_mesh(n_antenna=3, devices=["cpu"] * 8)


def test_init_distributed_noop_without_coordinator(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert mesh_lib.init_distributed() is False


def test_init_distributed_needs_the_group_size(monkeypatch):
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    with pytest.raises(ValueError, match="num_processes and process_id"):
        mesh_lib.init_distributed()
