"""The port's sharded product path (`detect --devices N`,
runtime.sharded) vs the JAX package's, on the CPU.

One 1 s, 3-antenna chirp set written by the JAX simulator
(tests/test_sharded_detect.py's) goes through the JAX package's
`analyze_capture_sharded(paths, n_devices=8)` on its 8 virtual CPU devices
and the port's `analyze_capture_sharded(paths, devices=['cpu'] * 8)`: the
mesh, the power ranges, the acquired PRNs and their Dopplers and the TDOA
lags equal; baseline and threshold rtol 1e-5; the acquisition peaks rtol
2e-4 (float32 FFTs of another factorization); the fused PSD peak within
1e-3 dB at the same frequency. The JAX package fixes the TDOA slice at
its `SLICE_LEN` (4096); the port reads it from
`cfg.tdoa.correlation_slice_size` (ROADMAP C18), so the port runs at the
JAX width where the two are compared. The port's sharded PCF surface
equals its single-device `caf_accumulate_pcf` per antenna (rtol 2e-4,
atol 1e-3 * max). The port's CLI (`detect ... --devices 8 --device cpu`)
prints the JAX CLI's JSON, its TDOA lags those of the port's default
slice, and rejects each flag of the serial pipeline with the JAX CLI's
exit code and message.
"""
import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from gps_jamming_tpu import cli as jcli
from gps_jamming_tpu.runtime import sharded as jsharded
from gps_jamming_tpu.sim import scenario
from gps_jamming_tpu_torch import cli as tcli
from gps_jamming_tpu_torch.config import DEFAULT_CONFIG as CFG
from gps_jamming_tpu_torch.ops import caf, codes, iq
from gps_jamming_tpu_torch.parallel import fusion
from gps_jamming_tpu_torch.parallel import mesh as mesh_lib
from gps_jamming_tpu_torch.runtime import sharded

torch.set_num_threads(2)

FS = 2.048e6
# the port's config at the JAX package's TDOA slice
JAX_WIDTH = dataclasses.replace(CFG, tdoa=dataclasses.replace(
    CFG.tdoa, correlation_slice_size=jsharded.SLICE_LEN))


@pytest.fixture(scope="module")
def capture_set(tmp_path_factory):
    d = tmp_path_factory.mktemp("tshard")
    scn = scenario.JammerScenario(kind="chirp", position_m=(4.0, 3.0),
                                  start_s=0.3, duration_s=0.4, seed=7)
    ants = [(0.0, 0.0), (3.0, 0.0), (0.0, 3.0)]
    paths = [str(d / f"ant{i}.bin") for i in range(3)]
    scenario.write_capture_set(scn, ants, paths, int(FS), FS,
                               noise_std=1.0)
    return paths


@pytest.fixture(scope="module")
def jax_out(capture_set):
    return jsharded.analyze_capture_sharded(capture_set, n_devices=8)


@pytest.fixture(scope="module")
def port_out(capture_set):
    return sharded.analyze_capture_sharded(capture_set, devices=["cpu"] * 8,
                                           cfg=JAX_WIDTH)


def _same_analysis(got, want):
    assert got["mesh"] == want["mesh"]
    assert abs(got["psd_fused_peak_db"] - want["psd_fused_peak_db"]) < 1e-3
    assert got["psd_fused_peak_freq_hz"] == want["psd_fused_peak_freq_hz"]
    for g, w in zip(got["per_antenna"], want["per_antenna"], strict=True):
        assert g["file"] == w["file"]
        assert [list(r) for r in g["power_ranges_bytes"]] == \
            [list(r) for r in w["power_ranges_bytes"]]
        for k in ("baseline", "threshold"):
            assert g[k] == pytest.approx(w[k], rel=1e-5), k
    for g, w in zip(got["acquisition"], want["acquisition"], strict=True):
        assert [r["prn"] for r in g] == [r["prn"] for r in w]
        assert [r["doppler_hz"] for r in g] == [r["doppler_hz"] for r in w]
        np.testing.assert_allclose([r["peak"] for r in g],
                                   [r["peak"] for r in w], rtol=2e-4)
    assert got["tdoa_pairs"] == want["tdoa_pairs"]


def test_sharded_detect_matches_jax(port_out, jax_out):
    got = port_out
    assert got["mesh"] == {"antenna": 3, "time": 2, "devices": 6}
    assert list(got) == list(jax_out)
    _same_analysis(got, jax_out)
    s_b, _ = got["per_antenna"][0]["power_ranges_bytes"][0]
    assert abs(s_b / 2 / FS - 0.3) < 0.05
    assert len(got["tdoa_pairs"]) == 3
    assert all(abs(r["lag_samples"]) < 200 for r in got["tdoa_pairs"])
    json.dumps(got)


def test_sharded_pcf_equals_single_device(capture_set):
    """The head acquisition of the sharded path (8 periods per shard, two
    coherent groups) equals the port's single-device search of each
    antenna's 16 periods in 4 groups."""
    n_code, per_shard = 2048, 8 * 2048
    chunk = CFG.detector.power_chunk_samples
    n = os.path.getsize(capture_set[0]) // 2
    L = (n // (2 * chunk)) * chunk
    caps = [iq.read_iq_file(p, convention="centered", count=4 * L)
            for p in capture_set]
    head = np.stack([c.reshape(2, L)[:, :per_shard] for c in caps])
    planes = codes.gps_replica_table_host(FS, n_code)
    m = mesh_lib.make_mesh(3, 2, devices=["cpu"] * 6)
    surf = fusion.sharded_caf_acquire(head, m, planes, None, FS,
                                      method="pcf", group_blocks=4).numpy()
    rep = codes.replica_tensor(planes, "cpu")
    for i in range(3):
        want = caf.caf_accumulate_pcf(
            torch.from_numpy(head[i].reshape(-1, n_code)), rep, FS,
            n_groups=4).numpy()
        np.testing.assert_allclose(surf[i], want, rtol=2e-4,
                                   atol=1e-3 * want.max())


def _cli(mod, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_sharded_detect_cli_matches_jax(capture_set, port_out):
    rc, out, _ = _cli(tcli, ["detect", *capture_set, "--devices", "8",
                             "--device", "cpu"])
    assert rc == 0
    jrc, jout, _ = _cli(jcli, ["detect", *capture_set, "--devices", "8"])
    assert jrc == 0
    got, want = json.loads(out), json.loads(jout)
    assert list(got) == list(want)
    # the CLI runs the port's default slice, the JAX CLI its SLICE_LEN:
    # each lag as the port's function gives it at that width
    assert got["tdoa_pairs"] == sharded.analyze_capture_sharded(
        capture_set, devices=["cpu"] * 8)["tdoa_pairs"]
    assert want["tdoa_pairs"] == port_out["tdoa_pairs"]
    _same_analysis(dict(got, tdoa_pairs=port_out["tdoa_pairs"]), want)


@pytest.mark.parametrize("flags", [
    ["--checkpoint", "d.ckpt"], ["--resume"], ["--hold"],
    ["--filter", "ekf"], ["--batch-receiver"], ["--wire-bits", "4"],
    ["--no-receiver"], ["--no-localize"], ["--telemetry-out", "t.jsonl"],
    ["--positions", "0,0;3,0;0,3"],
    ["--checkpoint", "d.ckpt", "--resume", "--no-localize"]])
def test_sharded_detect_rejects_the_serial_flags(capture_set, flags):
    argv = ["detect", *capture_set, "--devices", "8"] + flags
    want = _cli(jcli, argv)
    got = _cli(tcli, argv + ["--device", "cpu"])
    assert want[0] == got[0] == 2
    assert got[1] == want[1] == ""
    assert got[2] == want[2]
