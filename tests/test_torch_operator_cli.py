"""The port's operator verbs through `cli.main` on the CPU (`--device
cpu`), each against the JAX CLI's output on the same files.

- simulate: the JSON equal; the captures of the deterministic kinds
  (noise 0, no weakening) within 1 LSB byte for byte, as
  tests/test_torch_sim.py holds the writers;
- spectrum: chunks, nperseg and the peak's frequency equal, the dB
  figures within 1e-3 dB, the .npz arrays likewise;
- report: the JSON equal (events, CSV fixes, the file list) and the files
  written, the telemetry the same number of records;
- serve: in a child process on a free port, its /state.json after the
  auto-started analysis equal to the JAX dashboard's replay of the same
  files (records, events, triangulation within 1e-3 m);
- record --dry-run and info: the JSON equal;
- analyze: the rows equal within the float32 haversine's 1e-6 relative,
  1e-3 m, the CSV table too.
"""
import json
import math
import os
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from gps_jamming_tpu import cli as jcli
from gps_jamming_tpu.runtime import dashboard as jdashboard
from gps_jamming_tpu_torch import cli

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


def _run(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out)


def _lsb(a, b):
    x = np.fromfile(a, np.uint8).astype(np.int16)
    y = np.fromfile(b, np.uint8).astype(np.int16)
    assert x.shape == y.shape and np.abs(x - y).max() <= 1
    assert np.mean(x != y) < 1e-3


@pytest.mark.parametrize("extra,antennas", [
    (["--kind", "chirp", "--noise", "0", "--seconds", "0.05",
      "--start", "0.01", "--duration", "0.02"], 3),
    (["--kind", "pulsed", "--noise", "0", "--seconds", "0.05",
      "--start", "0.0123", "--duration", "1"], 2),
    (["--kind", "cw", "--noise", "0", "--seconds", "0.1",
      "--jammer-x", "6", "--jammer-y", "0", "--jammer-end-x", "-6"], 1),
    (["--kind", "clean", "--no-weaken", "--seconds", "0.01"], 1),
    (["--kind", "clean", "--no-weaken", "--seconds", "0.01",
      "--end-lat", "50.062", "--end-lon", "19.941"], 1),
    (["--kind", "spoof", "--seconds", "0.01", "--start", "-1",
      "--overpower", "3.0"], 1),
])
def test_simulate_matches_jax(tmp_path, capsys, extra, antennas):
    a = ["simulate", "--antennas", str(antennas)] + extra
    got = _run(cli.main, a + ["--out", str(tmp_path / "t")] + CPU, capsys)
    want = _run(jcli.main, a + ["--out", str(tmp_path / "j")], capsys)
    assert got["scenario"] == want["scenario"]
    assert len(got["written"]) == len(want["written"]) == antennas
    if "spoof" in extra:      # AWGN of 4 LSB: jax.random is not reproduced
        for p, q in zip(got["written"], want["written"]):
            x = np.fromfile(p, np.uint8).astype(np.float64)
            y = np.fromfile(q, np.uint8).astype(np.float64)
            assert x.size == y.size
            assert abs(x.std() / y.std() - 1.0) < 0.05
        return
    for p, q in zip(got["written"], want["written"]):
        _lsb(p, q)


def test_simulate_weakened_and_with_gps(tmp_path, capsys):
    """The noisy modes: the JSON equal, the written spread that of the JAX
    package's render (jax.random is not reproduced)."""
    for a in (["--kind", "clean", "--seconds", "0.02"],
              ["--kind", "cw", "--with-gps", "--seconds", "0.05",
               "--start", "0.02", "--duration", "0.02", "--jammer-x", "1",
               "--jammer-y", "1"]):
        a = ["simulate", "--antennas", "1"] + a
        got = _run(cli.main, a + ["--out", str(tmp_path / "t")] + CPU,
                   capsys)
        want = _run(jcli.main, a + ["--out", str(tmp_path / "j")], capsys)
        assert got["scenario"] == want["scenario"]
        x = np.fromfile(got["written"][0], np.uint8).astype(np.float64)
        y = np.fromfile(want["written"][0], np.uint8).astype(np.float64)
        assert abs(x.std() / y.std() - 1.0) < 0.05


@pytest.fixture(scope="module")
def jammed_set(tmp_path_factory):
    """`simulate` with its defaults (3 antennas, chirp at (4, 3) m, 0.3-0.7
    s of a 1 s capture) through the port's CLI."""
    d = tmp_path_factory.mktemp("opcli")
    assert cli.main(["simulate", "--out", str(d / "ant"), "--seconds", "1",
                     "--device", "cpu"]) == 0
    return [str(d / f"ant{i}.bin") for i in range(3)]


def test_spectrum_matches_jax(tmp_path, capsys, jammed_set):
    f = jammed_set[0]
    for extra in ([], ["--max-seconds", "0.5"]):
        got = _run(cli.main, ["spectrum", f, "--out",
                              str(tmp_path / "t.npz")] + extra + CPU, capsys)
        want = _run(jcli.main, ["spectrum", f, "--out",
                                str(tmp_path / "j.npz")] + extra, capsys)
        assert list(got) == list(want)
        for k in ("chunks", "nperseg", "peak_freq_mhz"):
            assert got[k] == want[k], k
        for k in ("peak_db", "mean_noise_db"):
            assert got[k] == pytest.approx(want[k], abs=1e-3), k
        with np.load(tmp_path / "t.npz") as a, \
                np.load(tmp_path / "j.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            np.testing.assert_array_equal(a["freq_mhz"], b["freq_mhz"])
            for k in ("spectrogram_db", "mean_db"):
                np.testing.assert_allclose(a[k], b[k], atol=1e-3, rtol=0)


def test_report_matches_jax(tmp_path, capsys, jammed_set):
    got = _run(cli.main, ["report", *jammed_set, "--out",
                          str(tmp_path / "t")] + CPU, capsys)
    want = _run(jcli.main, ["report", *jammed_set, "--out",
                            str(tmp_path / "j")], capsys)
    assert got["n_events"] == want["n_events"] == 1
    assert got["n_csv_fixes"] == want["n_csv_fixes"]
    assert got["files"] == want["files"]
    assert set(got) == set(want)
    for name in got["files"]:
        assert (tmp_path / "t" / name).stat().st_size > 0, name
    n_t = len((tmp_path / "t" / "telemetry.jsonl").read_text().splitlines())
    n_j = len((tmp_path / "j" / "telemetry.jsonl").read_text().splitlines())
    assert n_t == n_j == 10


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _state(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/state.json",
                                timeout=5) as r:
        return json.loads(r.read())


def test_serve_matches_jax(jammed_set):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "gps_jamming_tpu_torch", "serve", *jammed_set,
         "--port", str(port), "--device", "cpu"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        st = None
        deadline = time.time() + 240
        while time.time() < deadline:
            try:
                st = _state(port)
            except OSError:
                st = None
            if st and st["running"] is False:
                break
            assert proc.poll() is None, proc.communicate()
            time.sleep(0.3)
        assert st and st["status"] == "analysis complete", st
    finally:
        proc.terminate()
        out, err = proc.communicate(timeout=30)
    assert f"http://127.0.0.1:{port}/" in out
    jstate = jdashboard.DashboardState()
    jdashboard.replay_analysis(jstate, jammed_set,
                               antenna_positions=[(0.0, 0.0), (3.0, 0.0),
                                                  (0.0, 3.0)])
    want = jstate.snapshot()
    assert st["records"] == want["records"] >= 9
    assert [(e["start_time"], e["end_time"]) for e in st["events"]] == \
        [(e["start_time"], e["end_time"]) for e in want["events"]]
    assert st["antennas"] == want["antennas"]
    for a, b in zip(st["triangulation"]["location_meters"],
                    want["triangulation"]["location_meters"]):
        assert a == pytest.approx(b, abs=1e-3)


def test_record_dry_run_matches_jax(capsys):
    for extra in ([], ["--antennas", "3", "--bias-tee", "--warmup", "2",
                       "--system", "glonass", "--seconds", "5"]):
        got = _run(cli.main, ["record", "--dry-run"] + extra + CPU, capsys)
        want = _run(jcli.main, ["record", "--dry-run"] + extra, capsys)
        assert got == want


def test_info_matches_jax(capsys, jammed_set):
    got = _run(cli.main, ["info", *jammed_set] + CPU, capsys)
    want = _run(jcli.main, ["info", *jammed_set], capsys)
    assert got == want
    assert got[0]["iq_samples"] == 2048000


def _log(path, lat0, n=15):
    from gps_jamming_tpu_torch.runtime import telemetry
    rng = np.random.default_rng(int(lat0 * 1e4) % 1000)
    log = telemetry.TelemetryLog()
    for i in range(n):
        fix = type("F", (), {"nsat": 0 if i < 2 else 6,
                             "lat_deg": lat0 + rng.normal(0, 1e-5),
                             "lon_deg": 19.94 + rng.normal(0, 1e-5),
                             "height_m": 219.0 + rng.normal(0, 2.0),
                             "gdop": 1.9, "clock_bias_m": 100.0 + 2.0 * i})()
        log.append(telemetry.make_record(0.1 * i, 0.1 * i, 100 * i,
                                         fix=fix))
    log.save_jsonl(path)
    return path


def test_analyze_matches_jax(tmp_path, capsys):
    logs = [_log(str(tmp_path / "a.jsonl"), 50.06),
            _log(str(tmp_path / "b.jsonl"), 50.0602)]
    ref = ["--ref-lat", "50.06", "--ref-lon", "19.94", "--ref-hgt", "219"]
    got = _run(cli.main, ["analyze", *logs, *ref, "--out",
                          str(tmp_path / "t.csv")] + CPU, capsys)
    want = _run(jcli.main, ["analyze", *logs, *ref, "--out",
                            str(tmp_path / "j.csv")], capsys)
    assert len(got) == len(want) == 2

    def same(a, b):
        assert type(a) is type(b) or isinstance(b, (int, float))
        if isinstance(b, dict):
            assert list(a) == list(b)
            for k in b:
                same(a[k], b[k])
        elif isinstance(b, float) and math.isnan(b):
            assert math.isnan(a)
        elif isinstance(b, float):
            assert a == pytest.approx(b, rel=1e-6, abs=1e-3)
        else:
            assert a == b
    for a, b in zip(got, want):
        same(a, b)
    t = (tmp_path / "t.csv").read_text().splitlines()
    j = (tmp_path / "j.csv").read_text().splitlines()
    assert t[0] == j[0] and len(t) == len(j) == 3


def test_device_verbs_default_to_the_card(monkeypatch, tmp_path,
                                          jammed_set):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["simulate", "--out", str(tmp_path / "x"),
                  "--seconds", "0.01"],
                 ["spectrum", jammed_set[0]],
                 ["report", *jammed_set, "--out", str(tmp_path / "r")],
                 ["serve", "--port", "0"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)
