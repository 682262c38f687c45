"""The port's streaming product path vs the JAX package, on the CPU:
`analyze_capture(streaming=True)` with the streaming receiver, its live
sink and its detect-level checkpoint, `StreamProcessor`, and the CLI's
streaming verbs.

- A port-rendered GPS capture (sim.constellation, 1.024 MS/s, 2.5 s, x12
  into a uint8 .bin) with a seeded NumPy broadband jam from 0.6 to 1.4 s,
  through both `analyze_capture(streaming=True, segment_s=0.5)` with a
  live sink (the default 32 slots): power ranges, events, the flag trace
  and every telemetry record are equal exactly (no nav decode happens in
  2.5 s, so the records carry no fix and no float of the tracker; the
  flags' C/N0 input, the mean over the tracked slots, agrees within 0.3
  dB outside the jam, pull-in included, far from the F2 threshold); the
  tracked spans are equal as sets; the live sink's records (the frames of
  the 4 whole segments) equal the JAX package's one for one (frame
  indices and content), and equal the final log's prefix but for the
  'jamming' key and, after the first trimmed epoch, the tracked list (a
  health reset trims the crushed tail from the final spans; the live list
  held the satellite when it was emitted).
- The detect-level checkpoint on the port: a run killed by its sink after
  1.2 s, resumed, gives the uninterrupted run's events, records and
  jamming trace exactly; a checkpoint of another invocation raises.
- The port's detector on a partial frame stream, unpadded (the live
  path's use), gives the flags of the JAX package's
  `_detector_trace_bucketed`.
- `StreamProcessor` against tests/test_streaming.py's two cases: the
  streamed profile equals the one-shot batch profile (rtol 1e-5) and the
  JAX package's streamed profile and PSD (rtol 1e-5); a run interrupted
  after one block resumes to the same result.
- The CLI in a subprocess (`--device cpu`): `detect` (streaming by
  default), `detect --checkpoint` then `--resume`, `detect --wire-bits 4`
  and `receiver --streaming --segment-seconds 0.25` print the JAX CLI's
  keys and its values (the RSSI distances rtol 1e-5, TDOA lags 1e-3
  samples, as tests/test_torch_pipeline.py).
"""
import contextlib
import io
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_jamming_tpu import cli as jcli
from gps_jamming_tpu.config import DEFAULT_CONFIG as JCFG
from gps_jamming_tpu.models import detector as jdet
from gps_jamming_tpu.ops import iq as jiq
from gps_jamming_tpu.runtime import pipeline as jpipe
from gps_jamming_tpu.runtime import streaming as jstream
from gps_jamming_tpu.sim import scenario
from gps_jamming_tpu_torch.config import DEFAULT_CONFIG as CFG
from gps_jamming_tpu_torch.models import detector as tdet
from gps_jamming_tpu_torch.ops import iq
from gps_jamming_tpu_torch.runtime import pipeline as tpipe
from gps_jamming_tpu_torch.runtime import streaming as tstream
from gps_jamming_tpu_torch.sim import constellation

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 1.024e6
JAM_S = (0.6, 1.4)
TOTAL_S = 2.5
KW = dict(localize=False, sample_rate=FS, segment_s=0.5, emit_every_s=0.5)


@pytest.fixture(scope="module")
def gps_jam(tmp_path_factory):
    n = int(TOTAL_S * FS)
    x, _, _ = constellation.simulate_constellation(
        constellation.gps_shell(345600.0), (50.06, 19.94, 219.0),
        345600.0 - 1.3, n, FS, noise_std=0.4, seed=6)
    rng = np.random.default_rng(3)
    s0, s1 = int(JAM_S[0] * FS), int(JAM_S[1] * FS)
    x[s0:s1] += 400.0 * (rng.standard_normal(s1 - s0)
                         + 1j * rng.standard_normal(s1 - s0))
    path = str(tmp_path_factory.mktemp("spipe") / "jam.bin")
    iq.write_iq_file(path, x * 12.0)
    return path


@pytest.fixture(scope="module")
def runs(gps_jam):
    """(port result, port live records, JAX result, JAX live records)."""
    tlive, jlive = [], []
    got = tpipe.analyze_capture([gps_jam], sink=tlive.append, device="cpu",
                                **KW)
    want = jpipe.analyze_capture([gps_jam], sink=jlive.append, **KW)
    return got, tlive, want, jlive


def test_streaming_analyze_capture_matches_jax(runs):
    got, _, want, _ = runs
    assert got.power_ranges == want.power_ranges and len(got.power_ranges)
    assert got.events == want.events and len(got.events) == 1
    for k in want.flags_trace:
        np.testing.assert_array_equal(got.flags_trace[k],
                                      np.asarray(want.flags_trace[k]))
    assert got.telemetry.records == want.telemetry.records
    assert len(got.telemetry.records) == 25
    g, w = got.receiver, want.receiver
    assert set(g.tracked_spans) == set(w.tracked_spans)
    assert any(b < 2000 for _, _, b in g.tracked_spans)      # a reset
    clean = np.r_[0:int(JAM_S[0] * 1000), int(JAM_S[1] * 1000) + 500:2000]
    np.testing.assert_allclose(g.cn0_epochs[clean],
                               np.asarray(w.cn0_epochs)[clean], atol=0.3)
    # the jam thins the tracked list and a satellite tracked before it is
    # tracked again after it
    recs = got.telemetry.records
    pre = set(recs[4]["tracked"])
    mid = set(recs[12]["tracked"])
    post = set(recs[18]["tracked"])     # 1.9 s, in the last segment
    assert len(mid) < len(pre) and pre & post
    assert set(g.stage_seconds) == {
        "win_wait", "probes", "acquire", "scan", "book", "ckpt_cb",
        "final_decode", "n_acquire_calls"}
    assert set(got.stage_seconds) == {"prescan", "receiver", "detector",
                                      "records"}


def test_live_sink_matches_jax(runs):
    got, tlive, _, jlive = runs
    assert tlive == jlive
    assert len(tlive) == 20          # the 4 whole segments' frames
    # a health reset trims the crushed tail from the final spans, so the
    # final log drops a reset satellite from the frames of its last two
    # segments, which the live records emitted before the reset list
    final = got.telemetry.records
    for live, post in zip(tlive, final):
        assert set(post["tracked"]) <= set(live["tracked"])
        if live["elapsed_time"] <= 0.5:
            assert {k: v for k, v in live.items() if k != "jamming"} == post
        else:
            assert {k: v for k, v in live.items()
                    if k not in ("jamming", "tracked")} == \
                {k: v for k, v in post.items() if k != "tracked"}
    assert [r["jamming"] for r in tlive] == \
        got.flags_trace["jamming"].tolist()[:20]


class _Kill(Exception):
    pass


def test_detect_checkpoint_resume_bitwise(gps_jam, runs, tmp_path):
    ref = runs[0]
    ck = str(tmp_path / "detect.ckpt")
    live1 = []

    def killing_sink(rec):
        live1.append(rec)
        if rec["elapsed_time"] > 1.2:
            raise _Kill()

    with pytest.raises(_Kill):
        tpipe.analyze_capture([gps_jam], checkpoint_path=ck,
                              checkpoint_every_s=0.5, sink=killing_sink,
                              device="cpu", **KW)
    assert os.path.exists(ck) and os.path.exists(ck + ".rx")
    live2 = []
    res = tpipe.analyze_capture([gps_jam], checkpoint_path=ck,
                                checkpoint_every_s=0.5, resume=True,
                                sink=live2.append, device="cpu", **KW)
    assert json.dumps(res.events, sort_keys=True) == \
        json.dumps(ref.events, sort_keys=True)
    assert json.dumps(res.telemetry.records, sort_keys=True) == \
        json.dumps(ref.telemetry.records, sort_keys=True)
    np.testing.assert_array_equal(res.flags_trace["jamming"],
                                  ref.flags_trace["jamming"])
    assert res.receiver.tracked_spans == ref.receiver.tracked_spans
    np.testing.assert_array_equal(res.receiver.cn0_epochs,
                                  ref.receiver.cn0_epochs)
    f1 = {round(r["elapsed_time"], 3) for r in live1}
    f2 = {round(r["elapsed_time"], 3) for r in live2}
    assert f2 and min(f2) <= max(f1) + 0.101
    with pytest.raises(ValueError, match="detect checkpoint"):
        tpipe.analyze_capture([gps_jam], checkpoint_path=ck, resume=True,
                              system="glonass", device="cpu", **KW)


@pytest.mark.parametrize("n_frames", [1, 7, 40, 256, 300])
def test_detector_trace_matches_bucketed(n_frames):
    rng = np.random.default_rng(n_frames)
    t = (np.arange(n_frames) + 1) * 0.1
    cn0 = np.where((t > 1.0) & (t < 2.2), 20.0, 45.0) \
        + rng.standard_normal(n_frames)
    frames = dict(time_s=t,
                  buffcnt=((np.arange(n_frames) + 1) * 409600).astype(
                      np.int64),
                  cn0_avg=cn0.astype(np.float32),
                  residual_median=rng.uniform(0, 40, n_frames).astype(
                      np.float32),
                  residual_bad_count=rng.integers(0, 3, n_frames).astype(
                      np.float32),
                  hgt=(200 + rng.standard_normal(n_frames)).astype(
                      np.float32),
                  nsat=np.full(n_frames, 6.0, np.float32))
    ranges = [(409600 * 8, 409600 * 20)]
    tpad, tn = tdet.ranges_to_padded(ranges)
    jpad, jn = jdet.ranges_to_padded(ranges)
    _, got = tdet.run_detector(tdet.TelemetryFrames(**frames), tpad, tn,
                               CFG.detector)
    want = jpipe._detector_trace_bucketed(jdet.TelemetryFrames(**frames),
                                          jpad, jn, JCFG.detector)
    for f in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


# --- StreamProcessor ---------------------------------------------------------

@pytest.fixture(scope="module")
def long_capture(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("stream") / "long.bin")
    scn = scenario.JammerScenario(kind="broadband", position_m=(3.0, 2.0),
                                  start_s=1.1, duration_s=0.9, seed=11)
    scenario.write_capture_set(scn, [(0.0, 0.0)], [p], int(3 * 2.048e6),
                               2.048e6, noise_std=1.0)
    return p


def test_stream_processor_matches_batch_and_jax(long_capture):
    res = tstream.StreamProcessor(device="cpu").process_file(long_capture)
    cap = iq.read_iq_file(long_capture, convention="centered")
    batch = tdet.power_profile(torch.from_numpy(cap), CFG.detector)
    np.testing.assert_allclose(res.profile.power_map.numpy(),
                               batch.power_map.numpy(), rtol=1e-5)
    assert res.ranges == tdet.power_profile_ranges(batch, CFG.detector)
    assert len(res.events) == 1
    assert abs(res.events[0]["start_s"] - 1.1) < 0.05
    assert abs(res.events[0]["end_s"] - 2.0) < 0.05
    assert res.psd.shape == (CFG.spectral.nperseg,)
    want = jstream.StreamProcessor().process_file(long_capture)
    np.testing.assert_allclose(res.profile.power_map.numpy(),
                               np.asarray(want.profile.power_map),
                               rtol=1e-5)
    assert res.ranges == want.ranges and res.events == want.events
    assert res.n_blocks == want.n_blocks == 3
    np.testing.assert_allclose(res.psd, np.asarray(want.psd), rtol=1e-5,
                               atol=1e-5 * float(np.max(want.psd)))
    batch_j = jdet.power_profile(jnp.asarray(jiq.read_iq_file(
        long_capture, convention="centered")), JCFG.detector)
    assert res.ranges == jdet.power_profile_ranges(batch_j, JCFG.detector)


def test_stream_processor_checkpoint_resume(long_capture, tmp_path):
    proc = tstream.StreamProcessor(device="cpu")
    ck = str(tmp_path / "ck.npz")
    partial = proc.process_file(long_capture, checkpoint_path=ck,
                                checkpoint_every_blocks=1, max_blocks=1)
    assert partial.n_blocks == 1
    st = tstream.StreamState.load(ck)
    assert st.offset_samples == proc.block
    resumed = proc.process_file(long_capture, state=st)
    full = tstream.StreamProcessor(device="cpu").process_file(long_capture)
    np.testing.assert_array_equal(resumed.profile.power_map.numpy(),
                                  full.profile.power_map.numpy())
    assert resumed.ranges == full.ranges
    np.testing.assert_allclose(resumed.psd * resumed.state.psd_blocks,
                               full.psd * full.state.psd_blocks, rtol=1e-6)


# --- the command line --------------------------------------------------------

ANTS = [(0.0, 0.0), (3.0, 0.0), (0.0, 3.0)]


@pytest.fixture(scope="module")
def capture_set(tmp_path_factory):
    """tests/test_pipeline.py's 1 s, 3-antenna chirp set (2.048 MS/s)."""
    d = tmp_path_factory.mktemp("cli")
    scn = scenario.JammerScenario(kind="chirp", position_m=(4.0, 3.0),
                                  start_s=0.3, duration_s=0.4, seed=7)
    paths = [str(d / f"ant{i}.bin") for i in range(3)]
    scenario.write_capture_set(scn, ANTS, paths, int(2.048e6), 2.048e6,
                               noise_std=1.0)
    return paths


def _port_cli(*args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
               PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", "gps_jamming_tpu_torch",
                        *args, "--device", "cpu"], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout)


def _jax_cli(*args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jcli.main(list(args)) == 0
    return json.loads(buf.getvalue())


def _keys(d):
    if isinstance(d, dict):
        return {k: _keys(v) for k, v in d.items()}
    if isinstance(d, list):
        return [_keys(v) for v in d]
    return None


def _same_detect(got, want):
    assert _keys(got) == _keys(want)
    for k in ("power_ranges_bytes", "events", "n_events", "last_safe_fix",
              "fix", "acquired_prns"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["localization"]["distances"],
                               want["localization"]["distances"], rtol=1e-5)
    np.testing.assert_allclose(
        [p["lag_samples"] for p in got["tdoa"]["pairs"]],
        [p["lag_samples"] for p in want["tdoa"]["pairs"]], atol=1e-3)
    assert got["n_events"] == 1


@pytest.mark.parametrize("flags", [[], ["--wire-bits", "4"]])
def test_cli_detect_streams_by_default(capture_set, flags):
    _same_detect(_port_cli("detect", *capture_set, *flags),
                 _jax_cli("detect", *capture_set, *flags))


def test_cli_detect_checkpoint_and_resume(capture_set, tmp_path):
    ck = str(tmp_path / "d.ckpt")
    want = _jax_cli("detect", *capture_set)
    _same_detect(_port_cli("detect", *capture_set, "--checkpoint", ck),
                 want)
    assert os.path.exists(ck)
    _same_detect(_port_cli("detect", *capture_set, "--checkpoint", ck,
                           "--resume"), want)


def test_cli_receiver_streaming_matches_jax(capture_set):
    args = ("receiver", capture_set[0], "--streaming", "--segment-seconds",
            "0.25")
    got, want = _port_cli(*args), _jax_cli(*args)
    assert _keys(got) == _keys(want)
    for k in ("decoded_prns", "messages", "filter", "n_fixes", "fix"):
        assert got[k] == want[k], k
    assert [a["prn"] for a in got["acquired"]] == \
        [a["prn"] for a in want["acquired"]]
