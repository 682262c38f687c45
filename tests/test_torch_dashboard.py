"""The port's live dashboard (runtime/dashboard.py) on the CPU: the JAX
package's tests/test_dashboard.py cases against the port, its state after
a start equal to the JAX dashboard's on the same files, and a stop in the
middle of a streaming analysis followed by a clean restart.

The stop raises AnalysisStopped inside the live sink, in the streaming
receiver's segment callback: the IO worker must be drained and the
receiver's workers stopped on the way out (no `rx-io`/`rx-dec` thread
survives), and a second start on the same controller must run to the
same state as the first.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from gps_jamming_tpu.runtime import dashboard as jdashboard
from gps_jamming_tpu_torch.runtime import dashboard, telemetry
from gps_jamming_tpu_torch.sim import scenario

torch.set_num_threads(2)

FS = 2.048e6
ANTS = [(0.0, 0.0), (3.0, 0.0), (0.0, 3.0)]


class _Fix:
    nsat, lat_deg, lon_deg, height_m = 7, 50.06, 19.94, 219.0
    gdop, clock_bias_m = 1.8, 12.5


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.read()


def _post(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _serve(state, controller=None):
    srv = dashboard.make_server(state, port=0, controller=controller)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def test_dashboard_roundtrip():
    state = dashboard.DashboardState()
    srv, base = _serve(state)
    try:
        rec = telemetry.make_record(
            1.0, 345601.0, 4096000, acq_prns=[5, 13], tracked_prns=[5],
            decoded_prns=[5], fix=_Fix(),
            observations=[telemetry.make_observation(
                5, 345601.0, 2400, 48.0, 1200.0, 110.0, 45.0, 3.0)])
        sink = telemetry.HttpSink(f"{base}/data")
        assert sink(rec)
        urllib.request.urlopen(urllib.request.Request(
            f"{base}/event",
            data=json.dumps({"start_time": 2.5, "end_time": 4.0,
                             "flags": "F1"}).encode(),
            headers={"Content-Type": "application/json"}), timeout=5)
        st = json.loads(_get(f"{base}/state.json"))
        assert st["records"] == 1
        assert st["latest"]["position"]["nsat"] == 7
        assert st["track"] == [[50.06, 19.94]]
        assert st["events"][0]["flags"] == "F1"
        assert st["running"] is None           # no controller
        page = _get(f"{base}/").decode()
        assert "dashboard" in page and "/state.json" in page
        assert page == jdashboard._PAGE
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(urllib.request.Request(
                f"{base}/control", data=b'{"action": "stop"}'), timeout=5)
        assert err.value.code == 403            # no controller
    finally:
        srv.shutdown()
        srv.server_close()


def test_dashboard_state_gating():
    state = dashboard.DashboardState()
    # records without a 4-sat fix don't pollute the track
    state.add_record({"position": {"nsat": 2, "lat": 1.0, "lon": 1.0}})
    state.add_record({"position": {"nsat": 5, "lat": 2.0, "lon": 3.0}})
    snap = state.snapshot()
    assert snap["track"] == [[2.0, 3.0]]
    assert snap["records"] == 2
    state.reset()
    assert state.snapshot()["records"] == 0


@pytest.fixture(scope="module")
def jammed_set(tmp_path_factory):
    """The JAX test's 1 s chirp set (jam 0.3-0.7 s at (4, 3) m), rendered
    by the port's simulator."""
    d = tmp_path_factory.mktemp("dash")
    scn = scenario.JammerScenario(kind="chirp", position_m=(4.0, 3.0),
                                  start_s=0.3, duration_s=0.4, seed=7)
    paths = [str(d / f"ant{i}.bin") for i in range(3)]
    scenario.write_capture_set(scn, ANTS, paths, int(FS), FS, noise_std=1.0,
                               device="cpu")
    return paths


def _run_to_end(base, ctl, paths, **extra):
    code, r = _post(f"{base}/control", {
        "action": "start", "files": paths, "system": "gps",
        "threshold_db": 6.0, "receiver": True,
        "positions": [[0, 0], [3, 0], [0, 3]], **extra})
    assert code == 200 and r["ok"], r
    ctl.join(300)
    return json.loads(_get(f"{base}/state.json"))


def test_control_surface_start_watch(jammed_set):
    """Start from POST /control, watch the records, the events and the
    triangulation arrive, with the JAX test's checks, and the state equal
    to the JAX dashboard's replay of the same files."""
    paths = jammed_set
    state = dashboard.DashboardState()
    ctl = dashboard.AnalysisController(state, device="cpu")
    srv, base = _serve(state, ctl)
    try:
        assert _post(f"{base}/control", {"action": "dance"})[0] == 409
        code, r = _post(f"{base}/control",
                        {"action": "start", "files": ["/nope.bin"]})
        assert code == 409 and "not found" in r["message"]
        assert _post(f"{base}/control", {"action": "start", "files": paths,
                                         "system": "loran"})[0] == 409
        assert _post(f"{base}/control", {
            "action": "start", "files": paths,
            "positions": [[0, None]]})[0] == 409
        assert _post(f"{base}/control", {"action": "stop"})[0] == 409

        code, r = _post(f"{base}/control", {
            "action": "start", "files": paths, "system": "gps",
            "threshold_db": 6.0, "receiver": True,
            "positions": [[0, 0], [3, 0], [0, 3]]})
        assert code == 200 and r["ok"], r
        code2, r2 = _post(f"{base}/control", {
            "action": "start", "files": paths, "receiver": True})
        if code2 == 200:                 # the first run may be done
            ctl.join(300)
        else:
            assert "already running" in r2["message"]
        ctl.join(300)
        st = json.loads(_get(f"{base}/state.json"))
        assert st["running"] is False
        assert st["records"] >= 9        # 1 s capture -> ~10 records
        assert len(st["events"]) >= 1    # the chirp jam detected
        assert st["antennas"] == [{"x": 0.0, "y": 0.0},
                                  {"x": 3.0, "y": 0.0},
                                  {"x": 0.0, "y": 3.0}]
        tri = st["triangulation"]
        assert tri and tri["success"] and len(tri["distances"]) == 3
        assert abs(tri["location_meters"][0] - 4.0) < 3.0
        assert st["status"] == "analysis complete"
        page = _get(f"{base}/").decode()
        for frag in ("/control", "ctlStart", "ctlStop", "Triangulation",
                     "L.control.layers", "opentopomap", "World_Imagery"):
            assert frag in page, frag
    finally:
        srv.shutdown()
        srv.server_close()

    jstate = jdashboard.DashboardState()
    jdashboard.replay_analysis(jstate, paths, antenna_positions=ANTS,
                               threshold_db=6.0)
    want = jstate.snapshot()
    assert st["records"] == want["records"]
    assert [(e["start_time"], e["end_time"]) for e in st["events"]] == \
        [(e["start_time"], e["end_time"]) for e in want["events"]]
    for a, b in zip(st["triangulation"]["location_meters"],
                    want["triangulation"]["location_meters"]):
        assert a == pytest.approx(b, abs=1e-3)


def _rx_threads():
    """The live streaming-receiver worker threads (either package's)."""
    return {t for t in threading.enumerate()
            if t.name.startswith(("rx-io", "rx-dec"))}


def test_stop_mid_analysis_then_restart(jammed_set, tmp_path):
    """A stop inside a streaming analysis leaves no receiver worker
    behind, and the next start on the same controller runs clean to the
    state of an uninterrupted run."""
    long_path = str(tmp_path / "long.bin")
    np.random.default_rng(0).integers(
        0, 256, int(2 * 20.0 * FS), dtype=np.uint8).tofile(long_path)
    before = _rx_threads()
    state = dashboard.DashboardState()
    ctl = dashboard.AnalysisController(state, device="cpu")
    srv, base = _serve(state, ctl)
    try:
        first = _run_to_end(base, ctl, jammed_set)
        assert first["status"] == "analysis complete"
        code, r = _post(f"{base}/control", {
            "action": "start", "files": [long_path], "system": "gps",
            "receiver": True, "emit_every_s": 0.1})
        assert code == 200, r
        deadline = time.time() + 300
        stopped = False
        while time.time() < deadline:
            st = json.loads(_get(f"{base}/state.json"))
            if not stopped and st["records"] > 0:
                assert _post(f"{base}/control",
                             {"action": "stop"})[0] == 200
                stopped = True
            if stopped and st["running"] is False:
                break
            time.sleep(0.05)
        ctl.join(60)
        st = json.loads(_get(f"{base}/state.json"))
        assert stopped and st["running"] is False
        assert st["status"] == "stopped by user", st["status"]
        assert not _rx_threads() - before       # none of this run's left
        again = _run_to_end(base, ctl, jammed_set)
        assert again["status"] == "analysis complete"
        for k in ("records", "events", "triangulation", "antennas"):
            assert again[k] == first[k], k
        assert not _rx_threads() - before
    finally:
        srv.shutdown()
        srv.server_close()


def test_controller_defaults_to_the_card(monkeypatch, jammed_set):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dashboard.AnalysisController(dashboard.DashboardState())
    with pytest.raises(RuntimeError, match="CUDA"):
        dashboard.replay_analysis(dashboard.DashboardState(), jammed_set)
