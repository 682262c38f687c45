"""The port's accuracy analysis (utils/analysis.py), plot and map exports
(utils/viz.py) and the telemetry HTTP sink (runtime/telemetry.HttpSink):
the JAX package's tests/test_analysis.py, test_viz_telemetry.py cases
against the port's copies, and the analysis tables equal to the JAX
package's on the same records (the haversine is float32 in both: errors
within 1e-6 relative, 1e-3 m)."""
import http.server
import json
import math
import threading

import numpy as np
import pytest

from gps_jamming_tpu.runtime import telemetry as jtelemetry
from gps_jamming_tpu.utils import analysis as janalysis
from gps_jamming_tpu_torch.runtime import telemetry
from gps_jamming_tpu_torch.utils import analysis, viz


class _Fix:
    def __init__(self, lat, lon, hgt, clk, nsat=6, gdop=2.0):
        self.lat_deg, self.lon_deg, self.height_m = lat, lon, hgt
        self.clock_bias_m, self.nsat, self.gdop = clk, nsat, gdop


def _make_log(lat0=50.06, lon0=19.94):
    recs = []
    # 3 frames without fix, then fixes drifting slightly
    for i in range(3):
        recs.append(telemetry.make_record(i * 0.1, i * 0.1, i * 100))
    rng = np.random.default_rng(1)
    for i in range(20):
        fix = _Fix(lat0 + rng.normal(0, 1e-5), lon0 + rng.normal(0, 1e-5),
                   219.0 + rng.normal(0, 3.0), 1000.0 + 0.5 * i)
        recs.append(telemetry.make_record(
            0.3 + i * 0.1, 0.3 + i * 0.1, 1000 + i,
            fix=fix, observations=[telemetry.make_observation(
                5, 100.0, 2400, 44.0 + i * 0.1, 1200.0, 30.0, 45.0, 1.0)]))
    return recs


def test_ttff_and_position_report():
    recs = _make_log()
    assert analysis.ttff(recs) == pytest.approx(0.3)
    rep = analysis.position_report(recs, 50.06, 19.94, 219.0)
    assert rep.n_fixes == 20
    assert rep.mean_error_m < 5.0
    assert rep.p95_error_m >= rep.median_error_m
    assert abs(rep.mean_height_error_m) < 3.0
    empty = analysis.position_report(recs[:3], 50.06, 19.94)
    assert empty.n_fixes == 0 and math.isnan(empty.mean_error_m)


def test_clock_stats_drift():
    st = analysis.clock_stats(_make_log())
    assert st["n"] == 20
    # injected drift: +0.5 m per 0.1 s = 5 m/s
    assert st["drift_m_per_s"] == pytest.approx(5.0, rel=0.05)


def test_per_prn_series():
    series = analysis.per_prn_series(_make_log())
    assert 5 in series
    assert series[5]["snr"].size == 20
    assert series[5]["snr"][0] == pytest.approx(44.0)


def _same_row(got, want):
    assert list(got) == list(want)
    for k in want:
        a, b = got[k], want[k]
        if isinstance(b, float) and math.isnan(b):
            assert math.isnan(a), k
        elif isinstance(b, float):
            assert a == pytest.approx(b, rel=1e-6, abs=1e-3), k
        else:
            assert a == b, k


def test_batch_report_equals_the_jax_packages(tmp_path):
    recs = _make_log()
    paths = []
    for i, rr in enumerate((recs, recs[:3], _make_log(50.0601, 19.9402))):
        p = str(tmp_path / f"run{i}.jsonl")
        log = telemetry.TelemetryLog()
        log.records = rr
        log.save_jsonl(p)
        paths.append(p)
    rows = analysis.batch_report(paths, 50.06, 19.94, 219.0)
    want = janalysis.batch_report(paths, 50.06, 19.94, 219.0)
    assert len(rows) == 3 and rows[0]["n_fixes"] == 20
    assert rows[0]["run"] == paths[0]
    for g, w in zip(rows, want):
        _same_row(g, w)
    for p in paths:
        recs_p = analysis.load_records(p)
        _same_row(analysis.clock_stats(recs_p),
                  janalysis.clock_stats(janalysis.load_records(p)))
    flat = [{k: v for k, v in r.items()} for r in rows]
    pc, pj = str(tmp_path / "t.csv"), str(tmp_path / "j.csv")
    analysis.batch_report_csv(flat, pc)
    janalysis.batch_report_csv(flat, pj)
    assert open(pc).read() == open(pj).read()
    n_t = analysis.export_position_csv(recs, str(tmp_path / "pt.csv"))
    n_j = janalysis.export_position_csv(recs, str(tmp_path / "pj.csv"))
    assert n_t == n_j == 20
    assert open(tmp_path / "pt.csv").read() == open(tmp_path / "pj.csv").read()


def test_batch_report_excel_contract(tmp_path):
    """True and a file where pandas and openpyxl are installed; False
    and no file otherwise, as the JAX package."""
    rows = [{"run": "a", "n_fixes": 3}]
    path = str(tmp_path / "t.xlsx")
    got = analysis.batch_report_excel(rows, path)
    assert got == janalysis.batch_report_excel(rows,
                                               str(tmp_path / "j.xlsx"))
    assert got == (tmp_path / "t.xlsx").exists()


def _record(t, lat=50.0, lon=19.9, nsat=5):
    fix = type("F", (), {"nsat": nsat, "lat_deg": lat, "lon_deg": lon,
                         "height_m": 210.0, "gdop": 1.9,
                         "clock_bias_m": 12.0})()
    return telemetry.make_record(t, t, int(t * 4096 * 2), [1, 2], [1], [1],
                                 fix=fix)


def test_http_sink_roundtrip():
    received = []

    class H(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers["Content-Length"])
            received.append(json.loads(self.rfile.read(n)))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), H)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        sink = telemetry.HttpSink(
            url=f"http://127.0.0.1:{srv.server_port}/data")
        log = telemetry.TelemetryLog()
        for t in (0.1, 0.2, 0.3):
            log.append(_record(t))
        assert sink.post_all(log) == 3
        assert sink.sent == 3 and sink.errors == 0
        assert len(received) == 3
        assert received[0]["position"]["nsat"] == 5
        assert received[2]["elapsed_time"] == 0.3
        # the wire body is the JAX package's for the same record
        jsink = jtelemetry.HttpSink(
            url=f"http://127.0.0.1:{srv.server_port}/data")
        assert jsink(received[0])
        assert received[3] == received[0]
    finally:
        srv.shutdown()
        srv.server_close()
    # unreachable endpoint -> graceful failure
    dead = telemetry.HttpSink(url="http://127.0.0.1:1/data", timeout_s=0.2)
    assert not dead(_record(0.5))
    assert dead.errors == 1 and dead.sent == 0


def test_plot_exports(tmp_path):
    rng = np.random.default_rng(0)
    sg = rng.normal(-90, 3, (20, 128))
    viz.save_waterfall_png(sg, np.linspace(-1, 1, 128), 1.0,
                           str(tmp_path / "wf.png"))
    viz.save_power_png(rng.gamma(2, 1, 500), 0.016, 6.0,
                       [(100, 150)], str(tmp_path / "pw.png"))
    xs = np.linspace(-10, 10, 50)
    err = rng.gamma(2, 5, (50, 50)) + 1.0
    viz.save_rssi_heatmap_png(err, xs, xs, [(0, 0), (3, 0)], (4.0, 3.0),
                              [(4.5, 2.5)], str(tmp_path / "hm.png"))
    series = {7: {"t": np.arange(10.0), "snr": rng.normal(45, 1, 10),
                  "doppler": rng.normal(1000, 5, 10),
                  "residual": rng.normal(3, 1, 10),
                  "el": np.linspace(30, 35, 10)}}
    viz.save_prn_series_png(series, str(tmp_path / "prn.png"))
    viz.save_sample_histogram_png(
        rng.integers(0, 256, 10000, dtype=np.uint8),
        str(tmp_path / "hist.png"))
    for f in ("wf.png", "pw.png", "hm.png", "prn.png", "hist.png"):
        assert (tmp_path / f).stat().st_size > 5000


def test_map_report(tmp_path):
    from gps_jamming_tpu.utils import viz as jviz
    kw = dict(track_lla=[(50.06, 19.94), (50.0601, 19.9401)],
              last_fix=(50.0601, 19.9401), jammer_lla=(50.0605, 19.9405),
              antennas_lla=[(50.06, 19.94)],
              events=[{"start_time": 8.0, "end_time": 14.0,
                       "flags": "F1+F2"}],
              localization={"location_meters": [4.0, 3.0]})
    path = str(tmp_path / "report.html")
    viz.save_map_report_html(path, **kw)
    html = open(path).read()
    assert "leaflet" in html
    assert "estimated jammer" in html
    assert "8.00" in html and "14.00" in html
    assert "50.0605,19.9405" in html.replace(" ", "")
    jpath = str(tmp_path / "j.html")
    jviz.save_map_report_html(jpath, **kw)
    assert open(jpath).read() == html
