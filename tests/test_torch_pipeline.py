"""The port's batch analysis pipeline (runtime.pipeline) and command line
(cli) vs the JAX package, on the CPU.

- Telemetry functions (`build_telemetry_frames`, `frame_observations`,
  `iter_records`) on twin fake receiver results, one per package, made of
  the same arrays: frames equal (floats rtol 1e-6), records equal.
- `analyze_capture` on the JAX simulator's 1 s, 3-antenna chirp set
  (tests/test_pipeline.py's): streaming=False with the receiver off and
  on, and streaming=True with the receiver off. Power ranges, events, the
  flag trace, the last safe fix and the telemetry records equal; RSSI
  distances rtol 1e-5 and its grid fix within one grid step; TDOA onsets
  equal, lags within 1e-3 samples and the hyperbolic position within 2 m
  (tests/test_torch_localization.py says why).
- `analyze_capture(system='galileo')` on the same set equals the JAX
  package's; an unknown system raises ValueError; no card and no device
  raises RuntimeError. The default call (the streaming receiver) equals
  the JAX package's, and with streaming=False the streaming receiver's
  options are ignored, as there
  (tests/test_torch_stream_pipeline.py holds the streaming path itself).
- The port's CLI in a subprocess (`--device cpu`) prints the JAX CLI's
  JSON keys and values on the same files (`detect` also with `--system
  galileo`; `receiver --system sbas` on a 2.5 s SBAS capture, its MT12
  rows); in process, the streaming receiver's flags (`detect` by
  default, `--checkpoint`, `--resume`, `--wire-bits`, `receiver
  --streaming`) do too; `--devices` with a flag of the serial pipeline
  exits 2 with the JAX CLI's message.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from gps_jamming_tpu import cli as jcli
from gps_jamming_tpu.config import DEFAULT_CONFIG as JCFG
from gps_jamming_tpu.models.receiver import observables as jobs
from gps_jamming_tpu.models.receiver import pvt as jpvt
from gps_jamming_tpu.models.receiver import receiver as jrx
from gps_jamming_tpu.runtime import pipeline as jpipe
from gps_jamming_tpu.runtime import telemetry as jtel
from gps_jamming_tpu.sim import scenario
from gps_jamming_tpu_torch import cli as tcli
from gps_jamming_tpu_torch.config import DEFAULT_CONFIG as CFG
from gps_jamming_tpu_torch.models.receiver import observables as tobs
from gps_jamming_tpu_torch.models.receiver import pvt as tpvt
from gps_jamming_tpu_torch.models.receiver import receiver as trx
from gps_jamming_tpu_torch.runtime import pipeline as tpipe
from gps_jamming_tpu_torch.runtime import telemetry as ttel

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 2.048e6
ANTS = [(0.0, 0.0), (3.0, 0.0), (0.0, 3.0)]


@pytest.fixture(scope="module")
def capture_set(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe")
    scn = scenario.JammerScenario(kind="chirp", position_m=(4.0, 3.0),
                                  start_s=0.3, duration_s=0.4, seed=7)
    paths = [str(d / f"ant{i}.bin") for i in range(3)]
    scenario.write_capture_set(scn, ANTS, paths, int(FS), FS, noise_std=1.0)
    return paths


# --- twin fake receiver results ----------------------------------------------

def _fake_result(obs_mod, pvt_mod, rx_mod):
    """Two tracked channels (PRN 7 decoded, PRN 9 not), PRN 12 acquired
    only, fixes every 200 ms with one invalid and a 500 ms gap."""
    n_ep = 1500
    rng = np.random.default_rng(4)

    def obs(prn, week, complete, cn0):
        return obs_mod.ChannelObservables(
            prn=prn, eph=types.SimpleNamespace(week=week, complete=complete),
            chips=np.arange(n_ep, dtype=np.float64) * 1023.0 + prn,
            anchor_chip=0.0, anchor_tow=345600.0 + prn,
            cn0_dbhz=(cn0 + rng.standard_normal(n_ep)).astype(np.float32),
            doppler_hz=np.full(n_ep, 100.0 * prn, np.float32),
            sync_quality=1.0, sample_offset=0.0, epoch_samples=2048)

    chans = [rx_mod.ChannelResult(prn=7, acquired=True, doppler_hz=700.0,
                                  code_phase_samples=10.0, peak_ratio=5.0,
                                  cn0_dbhz=44.0, obs=obs(7, 352, True, 44.0)),
             rx_mod.ChannelResult(prn=9, acquired=True, doppler_hz=900.0,
                                  code_phase_samples=20.0, peak_ratio=4.0,
                                  cn0_dbhz=40.0, obs=obs(9, 0, False, 40.0)),
             rx_mod.ChannelResult(prn=12, acquired=True, doppler_hz=0.0,
                                  code_phase_samples=0.0, peak_ratio=3.5,
                                  cn0_dbhz=33.0)]
    fixes, epochs = [], []
    for k, m in enumerate(list(range(200, 801, 200)) + [1300, 1500]):
        fixes.append(pvt_mod.PvtSolution(
            pos_ecef=np.zeros(3), clock_bias_m=3.0 + k,
            lat_deg=50.0 + (2.0 if k == 5 else 0.001 * k), lon_deg=19.9,
            height_m=210.0 + k, gdop=2.1,
            residuals_m=np.array([4.5 + k, 0.0, 900.0 * (k == 2)]),
            azimuth_deg=np.array([123.0, 45.0, 9.0]),
            elevation_deg=np.array([41.0, 30.0, 12.0]), nsat=3,
            valid=k != 3, innovations_m=np.array([1.25, 0.5, 0.0]),
            prns=np.array([7, 9, 30])))
        epochs.append(m)
    live = [c for c in chans if c.obs is not None]
    return rx_mod.ReceiverResult(
        chans, fixes, epochs, "gps", 1.0,
        cn0_epochs=np.mean([c.obs.cn0_dbhz for c in live], axis=0),
        tracked_spans=[(c.prn, 0, n_ep) for c in live],
        obs_spans=[(0, c.obs) for c in live])


@pytest.fixture(scope="module")
def fake_pair():
    return (_fake_result(tobs, tpvt, trx), _fake_result(jobs, jpvt, jrx))


@pytest.mark.parametrize("n_epochs", [1499, 1500, 2000])
def test_build_telemetry_frames_matches_jax(fake_pair, n_epochs):
    got = tpipe.build_telemetry_frames(fake_pair[0], n_epochs, 2048, CFG)
    want = jpipe.build_telemetry_frames(fake_pair[1], n_epochs, 2048, JCFG)
    for f in got._fields:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=f)
    assert got.residual_bad_count.max() == 1.0
    empty = tpipe.build_telemetry_frames(None, n_epochs, 2048, CFG)
    assert not np.asarray(empty.cn0_avg).any()


@pytest.mark.parametrize("frame_ms", [0, 100, 500, 1400, 1600])
@pytest.mark.parametrize("with_fix", [True, False])
def test_frame_observations_match_jax(fake_pair, frame_ms, with_fix):
    fix = fake_pair[0].fixes[1] if with_fix else None
    jfix = fake_pair[1].fixes[1] if with_fix else None
    assert tpipe.frame_observations(fake_pair[0], frame_ms, fix) == \
        jpipe.frame_observations(fake_pair[1], frame_ms, jfix)
    assert tpipe._week_adjust("gps") == jpipe._week_adjust("gps") == 2048


@pytest.mark.parametrize("hold", [True, False])
def test_iter_records_match_jax(fake_pair, hold):
    frames = tpipe.build_telemetry_frames(fake_pair[0], 1600, 2048, CFG)
    got = list(tpipe.iter_records(fake_pair[0], frames, hold,
                                  ttel.HoldPositionFilter()))
    want = list(jpipe.iter_records(fake_pair[1], frames, hold,
                                   jtel.HoldPositionFilter()))
    assert [r for _, r, _ in got] == [r for _, r, _ in want]
    assert [f for f, _, _ in got] == list(range(16))
    recs = [r for _, r, _ in got]
    assert any(r["position"]["hold"] for r in recs)
    # TIME| anchored on PRN 7's decoded week 352 + 2048 from frame 0 on
    assert all(r["time"].startswith("2026-01-07 23:59:") for r in recs)
    assert json.loads(json.dumps(recs)) == recs


# --- analyze_capture ---------------------------------------------------------

def _same_analysis(got, want):
    assert got.power_ranges == want.power_ranges
    assert got.events == want.events
    assert list(got.flags_trace) == list(want.flags_trace)
    for k in want.flags_trace:
        np.testing.assert_array_equal(got.flags_trace[k],
                                      np.asarray(want.flags_trace[k]))
    assert got.last_safe_fix == want.last_safe_fix
    assert got.telemetry.records == want.telemetry.records
    assert (got.localization is None) == (want.localization is None)
    if want.localization is not None:
        g, w = got.localization, want.localization
        assert list(g) == list(w) and g["success"] == w["success"]
        np.testing.assert_allclose(g["distances"], w["distances"],
                                   rtol=1e-5)
        step = 2 * 1.5 * max(w["distances"]) / 299 * 1.0001
        assert np.abs(np.subtract(g["location_meters"],
                                  w["location_meters"])).max() <= step
    assert (got.tdoa_result is None) == (want.tdoa_result is None)
    if want.tdoa_result is not None:
        g, w = got.tdoa_result, want.tdoa_result
        assert g["onsets"] == w["onsets"]
        np.testing.assert_allclose([p["lag_samples"] for p in g["pairs"]],
                                   [p["lag_samples"] for p in w["pairs"]],
                                   atol=1e-3)
        assert np.hypot(*np.subtract(g["position_m"],
                                     w["position_m"])) < 2.0


@pytest.mark.parametrize("streaming,receiver", [(False, False),
                                                (False, True),
                                                (True, False)])
def test_analyze_capture_matches_jax(capture_set, streaming, receiver):
    kw = dict(antenna_positions=ANTS, run_receiver=receiver,
              streaming=streaming)
    want = jpipe.analyze_capture(capture_set, **kw)
    got = tpipe.analyze_capture(capture_set, device="cpu", **kw)
    _same_analysis(got, want)
    assert len(got.events) == 1 and got.localization["success"]
    assert len(got.tdoa_result["pairs"]) == 3
    x, y = got.localization["location_meters"]
    assert np.hypot(x - 4.0, y - 3.0) < 3.0
    assert (got.receiver is None) == (not receiver)
    if receiver:
        assert len(got.telemetry.records) == 10
        assert [c.acquired for c in got.receiver.channels] == \
            [c.acquired for c in want.receiver.channels]
    want_stages = {"prescan", "detector", "records", "rssi", "tdoa"} | (
        {"receiver"} if receiver else set())
    assert set(got.stage_seconds) == want_stages


def test_analyze_capture_single_antenna_and_max_seconds(capture_set):
    kw = dict(run_receiver=False, streaming=False, max_seconds=0.5)
    want = jpipe.analyze_capture(capture_set[:1], **kw)
    got = tpipe.analyze_capture(capture_set[:1], device="cpu", **kw)
    _same_analysis(got, want)
    assert got.localization is None and got.tdoa_result is None


@pytest.mark.parametrize("kw", [dict(), dict(streaming=False, sink=print),
                                dict(streaming=False, checkpoint_path="x"),
                                dict(streaming=False, resume=True),
                                dict(streaming=False, wire_bits=4),
                                dict(streaming=False, segment_s=2.0),
                                dict(streaming=False, emit_every_s=1.0),
                                dict(streaming=False,
                                     checkpoint_every_s=5.0)])
def test_streaming_options_match_jax(capture_set, kw, tmp_path):
    """The default call (the streaming receiver; the 1 s captures hold no
    whole 4 s segment) and, with streaming=False, each option only the
    streaming receiver reads, which the batch path ignores as the JAX
    package's does."""
    kw = dict(kw)
    if "checkpoint_path" in kw:
        kw["checkpoint_path"] = str(tmp_path / "x.ckpt")
    if kw:
        kw.update(run_receiver=False, localize=False)
    want = jpipe.analyze_capture(capture_set, antenna_positions=ANTS, **kw)
    got = tpipe.analyze_capture(capture_set, antenna_positions=ANTS,
                                device="cpu", **kw)
    _same_analysis(got, want)
    assert len(got.events) == 1
    assert not os.path.exists(tmp_path / "x.ckpt")
    if not kw:
        assert got.receiver.tracked_spans == want.receiver.tracked_spans == []
        assert got.receiver.cn0_epochs.size == 0
        assert len(got.telemetry.records) == 10


def test_other_systems_and_no_card_raise(capture_set, monkeypatch):
    """Galileo runs the batch path as the JAX package's does (its default
    2.048 MS/s: B1's n = 8192 on the card); an unknown system, and no card
    with no device, raise."""
    kw = dict(streaming=False, system="galileo")
    want = jpipe.analyze_capture(capture_set[:1], **kw)
    got = tpipe.analyze_capture(capture_set[:1], device="cpu", **kw)
    _same_analysis(got, want)
    assert got.receiver.system == "galileo" and got.receiver.epoch_ms == 4.0
    assert [c.prn for c in got.receiver.channels] == list(range(1, 37))
    assert [c.acquired for c in got.receiver.channels] == \
        [c.acquired for c in want.receiver.channels]
    assert len(got.telemetry.records) == 10 and len(got.events) == 1
    with pytest.raises(ValueError, match="unknown system"):
        tpipe.analyze_capture(capture_set[:1], streaming=False,
                              system="beidou", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.analyze_capture(capture_set, streaming=False,
                              run_receiver=False)


# --- the command line ----------------------------------------------------------

def _port_cli(*args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
               PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", "gps_jamming_tpu_torch",
                        *args, "--device", "cpu"], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=300)
    return r


def _jax_cli(*args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jcli.main(list(args)) == 0
    return json.loads(buf.getvalue())


def _keys(d):
    """Nested key structure of a JSON value."""
    if isinstance(d, dict):
        return {k: _keys(v) for k, v in d.items()}
    if isinstance(d, list):
        return [_keys(v) for v in d]
    return None


@pytest.mark.parametrize("mode", ["--no-receiver", "--batch-receiver"])
def test_cli_detect_matches_jax(capture_set, tmp_path, mode):
    tel = str(tmp_path / "tel.jsonl")
    r = _port_cli("detect", *capture_set, mode, "--telemetry-out", tel)
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout)
    want = _jax_cli("detect", *capture_set, mode)
    assert _keys(got) == _keys(want)
    for k in ("power_ranges_bytes", "events", "n_events", "last_safe_fix"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["localization"]["distances"],
                               want["localization"]["distances"], rtol=1e-5)
    np.testing.assert_allclose([p["lag_samples"] for p in got["tdoa"]["pairs"]],
                               [p["lag_samples"] for p in want["tdoa"]["pairs"]],
                               atol=1e-3)
    if mode == "--batch-receiver":
        assert got["fix"] == want["fix"]
        assert got["acquired_prns"] == want["acquired_prns"]
        assert len(ttel.TelemetryLog.load_jsonl(tel).records) == 10


def test_cli_localize_calibrate_receiver_match_jax(capture_set):
    r = _port_cli("localize", *capture_set)
    assert r.returncode == 0, r.stderr[-2000:]
    got, want = json.loads(r.stdout), _jax_cli("localize", *capture_set)
    assert _keys(got) == _keys(want)
    np.testing.assert_allclose(got["rssi"]["distances"],
                               want["rssi"]["distances"], rtol=1e-5)
    r = _port_cli("calibrate", capture_set[1])
    assert r.returncode == 0, r.stderr[-2000:]
    got, want = json.loads(r.stdout), _jax_cli("calibrate", capture_set[1])
    assert list(got) == list(want)
    assert got["suggested_threshold"] == pytest.approx(
        want["suggested_threshold"], rel=1e-6)
    assert got["events_at_threshold"] == want["events_at_threshold"] != []
    r = _port_cli("receiver", capture_set[0], "--max-seconds", "0.5",
                  "--hold")
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout)
    want = _jax_cli("receiver", capture_set[0], "--max-seconds", "0.5",
                    "--hold")
    assert got == want


@pytest.fixture(scope="module")
def sbas_bin(tmp_path_factory):
    """2.5 s of SBAS PRN 129 (tests/test_sbas_channel.py's channel: +1250
    Hz, code phase 317.25 chips, MT12 messages of week 310 from ToW
    345600 s, noise 0.8), x12 in a uint8 .bin."""
    import jax
    from gps_jamming_tpu.models.receiver import sbas as jsbas
    from gps_jamming_tpu.ops import iq as jiq
    from gps_jamming_tpu.sim import gps as jsim
    sym = jsbas.encode_stream([jsbas.build_mt12(345600.0 + k, 310,
                                                preamble_idx=k % 3)
                               for k in range(3)])
    sat = jsim.SatelliteSignal(prn=129, doppler_hz=1250.0,
                               code_phase_chips=317.25,
                               nav_bits=tuple((2 * sym - 1).tolist()),
                               bit_periods=2)
    x = jsim.scene([sat], int(2.5 * FS), FS, noise_std=0.8,
                   key=jax.random.PRNGKey(11))
    path = str(tmp_path_factory.mktemp("sbas") / "sbas.bin")
    jiq.write_iq_file(path, (np.asarray(x) * 12.0).astype(np.complex64))
    return path


def test_cli_receiver_sbas_matches_jax(sbas_bin):
    """`receiver --system sbas`: the JAX CLI's keys and values, MT12
    message rows included, and no fix."""
    r = _port_cli("receiver", sbas_bin, "--system", "sbas")
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout)
    want = _jax_cli("receiver", sbas_bin, "--system", "sbas")
    assert _keys(got) == _keys(want)
    for k in ("decoded_prns", "messages", "filter", "n_fixes", "fix"):
        assert got[k] == want[k], k
    assert [a["prn"] for a in got["acquired"]] == \
        [a["prn"] for a in want["acquired"]]
    assert got["messages"] and got["n_fixes"] == 0 and got["fix"] is None
    assert {(m["prn"], m["mt"], m["week"]) for m in got["messages"]} == \
        {(129, 12, 310)}
    assert all(m["tow_s"] in (345600.0, 345601.0, 345602.0)
               for m in got["messages"])


def test_cli_detect_galileo_matches_jax(capture_set):
    """`detect --batch-receiver --system galileo` on the jammed set: the
    JAX CLI's keys and the values that must match."""
    r = _port_cli("detect", *capture_set, "--batch-receiver", "--system",
                  "galileo")
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout)
    want = _jax_cli("detect", *capture_set, "--batch-receiver", "--system",
                    "galileo")
    assert _keys(got) == _keys(want)
    for k in ("power_ranges_bytes", "events", "n_events", "last_safe_fix",
              "fix", "acquired_prns"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["localization"]["distances"],
                               want["localization"]["distances"], rtol=1e-5)
    assert got["n_events"] == 1


@pytest.mark.parametrize("argv", [
    ["detect"],
    ["detect", "--no-receiver", "--checkpoint", "CKPT"],
    ["detect", "--batch-receiver", "--resume"],
    ["detect", "--batch-receiver", "--wire-bits", "4"],
    ["receiver", "--streaming", "--segment-seconds", "0.25"]])
def test_cli_runs_the_streaming_flags(capture_set, argv, tmp_path, capsys):
    """The flags of the streaming receiver run and print the JAX CLI's
    keys and values, on the first 0.5 s of antenna 0."""
    args = [argv[0], capture_set[0], "--max-seconds", "0.5"] + [
        str(tmp_path / "d.ckpt") if a == "CKPT" else a for a in argv[1:]]
    assert tcli.main(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    want = _jax_cli(*args)
    assert _keys(got) == _keys(want)
    for k in ("power_ranges_bytes", "events", "n_events", "last_safe_fix",
              "fix", "acquired_prns", "decoded_prns", "messages",
              "filter", "n_fixes"):
        assert got.get(k) == want.get(k), k


@pytest.mark.parametrize("argv", [
    ["detect", "a.bin", "--devices", "4", "--checkpoint", "d.ckpt"]])
def test_cli_refuses_unported_flags(argv, capsys):
    """The sharded analysis rejects the serial pipeline's flags as the JAX
    CLI does: exit 2 and its message."""
    assert jcli.main(argv) == 2
    want = capsys.readouterr().err
    assert tcli.main(argv + ["--device", "cpu"]) == 2
    assert capsys.readouterr().err == want
    assert "not supported there: --checkpoint" in want
