"""The port's telemetry records (runtime.telemetry) and GPS time
(utils.gpstime) vs the JAX package on the same inputs.

Records are plain dicts in the sdrout.c schema: keys, value types and the
status-line text must be equal; floats within rtol 1e-6 (the port copies
the host code, so they come out equal).
"""
import datetime as dt
import json

import numpy as np
import pytest

from gps_jamming_tpu.config import DetectorConfig as JDetectorConfig
from gps_jamming_tpu.models.receiver.pvt import PvtSolution as JPvt
from gps_jamming_tpu.runtime import telemetry as jtel
from gps_jamming_tpu.utils import gpstime as jgps
from gps_jamming_tpu_torch.config import DetectorConfig
from gps_jamming_tpu_torch.models.receiver.pvt import PvtSolution
from gps_jamming_tpu_torch.runtime import telemetry as ttel
from gps_jamming_tpu_torch.utils import gpstime as tgps


def _assert_same(got, want):
    """Equal structure and types; floats within rtol 1e-6."""
    assert type(got) is type(want), (got, want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same(a, b)
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-6, abs=0.0)
    else:
        assert got == want


@pytest.mark.parametrize("week,tow", [(0, 0.0), (2400, 345600.0),
                                      (2401, 12.3456), (1900, 604799.999)])
def test_gpstime_matches_jax(week, tow):
    assert tgps.week_tow_to_calendar(week, tow) == \
        jgps.week_tow_to_calendar(week, tow)
    assert tgps.gpst_to_utc(week, tow) == jgps.gpst_to_utc(week, tow)
    utc = jgps.gpst_to_utc(week, tow)
    assert tgps.utc_to_gpst(utc) == jgps.utc_to_gpst(utc)
    assert tgps.leap_seconds(utc) == jgps.leap_seconds(utc)
    assert tgps.adjust_week_rollover(week % 1024) == \
        jgps.adjust_week_rollover(week % 1024)
    assert ttel.format_gps_time(week, tow, 1e-4) == \
        jtel.format_gps_time(week, tow, 1e-4)
    assert tgps.calendar_to_week_tow(2026, 10, 16, 12, 30, 1.5) == \
        jgps.calendar_to_week_tow(2026, 10, 16, 12, 30, 1.5)
    assert tgps.LEAP_TABLE == jgps.LEAP_TABLE
    assert tgps.GPS_EPOCH == jgps.GPS_EPOCH == dt.datetime(1980, 1, 6)


def _fix(cls):
    return cls(pos_ecef=np.array([3.8e6, 1.4e6, 4.9e6]), clock_bias_m=3.0,
               lat_deg=50.0612345678, lon_deg=19.9387654321, height_m=219.4,
               gdop=2.13, residuals_m=np.array([4.5, -1.25]),
               azimuth_deg=np.array([123.0, 45.5]),
               elevation_deg=np.array([41.0, 12.25]), nsat=7, valid=True,
               innovations_m=np.array([1.25, 0.5]), prns=np.array([7, 9]))


def _records(mod, pvt_cls):
    obs = [mod.make_observation(5, 345600.123, 2400, 45.04, 1200.55, 180.0,
                                45.0, 2.5, 0.75),
           mod.make_observation(17, 345600.2, 2400, 38.9, -2500.0, 7.5,
                                5.25, -12.5)]
    return [mod.make_record(0.1, 0.0, 409600),
            mod.make_record(1.5, 345600.0, 12345, acq_prns=[5, 17, 30],
                            tracked_prns=[5, 17], decoded_prns=[5],
                            observations=obs, week=2400),
            mod.make_record(20.7, 345619.4, 84_787_200,
                            acq_prns=np.array([5, 17]), tracked_prns=(5,),
                            decoded_prns=(5, 17), fix=_fix(pvt_cls),
                            observations=obs, hold=True, filter_name="EKF",
                            week=2400),
            mod.make_record(3.0, "2026-10-16 12:00:00.500", 6_000_000_000)]


def test_records_and_status_lines_match_jax():
    got, want = _records(ttel, PvtSolution), _records(jtel, JPvt)
    _assert_same(got, want)
    for g, w in zip(got, want):
        line = ttel.format_status_line(g)
        assert line == jtel.format_status_line(w)
        assert json.loads(json.dumps(g)) == g
    text = "GNSS-SDRLIB start!\n" + "\n".join(
        ttel.format_status_line(r) for r in got)
    back = ttel.parse_status_lines(text)
    _assert_same(back, jtel.parse_status_lines(text))
    assert [r["position"]["buffcnt"] for r in back] == \
        [409600, 12345, 84_787_200, 6_000_000_000]
    # the text round trip is the identity on the grammar lines
    assert "\n".join(ttel.format_status_line(r) for r in back) == \
        text.split("\n", 1)[1]


def test_parse_reference_log_matches_jax():
    recs = _records(ttel, PvtSolution)
    text = "".join(f"{'=' * 20}\n[2026-10-16 12:00:{i:02d}]\n"
                   f"{json.dumps(r, indent=2)}\n" for i, r in enumerate(recs))
    text += "=" * 20 + "\nnot a block\n"
    got = ttel.parse_reference_log(text)
    assert got == jtel.parse_reference_log(text)
    assert [r for _, r in got] == recs
    assert got[2][0] == "2026-10-16 12:00:02"


@pytest.mark.parametrize("enabled", [True, False])
def test_hold_position_filter_matches_jax(enabled):
    rng = np.random.default_rng(3)
    lat = 50.0 + np.cumsum(rng.normal(0, 0.4, 40))
    lon = 19.9 + np.cumsum(rng.normal(0, 0.4, 40))
    g = ttel.HoldPositionFilter(enabled=enabled)
    w = jtel.HoldPositionFilter(enabled=enabled)
    outs = [(g.apply(a, b, 200.0 + i), w.apply(a, b, 200.0 + i))
            for i, (a, b) in enumerate(zip(lat, lon))]
    for a, b in outs:
        assert a == b
    assert any(o[0][3] for o in outs) == enabled


def test_telemetry_log_jsonl_round_trip(tmp_path):
    log = ttel.TelemetryLog()
    for r in _records(ttel, PvtSolution):
        log.append(r)
    p = str(tmp_path / "t.jsonl")
    log.save_jsonl(p)
    back = ttel.TelemetryLog.load_jsonl(p)
    assert back.records == log.records
    assert jtel.TelemetryLog.load_jsonl(p).records == log.records
    jlog = jtel.TelemetryLog()
    jlog.records = list(log.records)
    assert log.to_csv_rows() == jlog.to_csv_rows()
    assert len(log.to_csv_rows()) == 1


def test_frames_from_records_matches_jax():
    recs = _records(ttel, PvtSolution)
    recs[1]["observations"][1]["residual"] = 900.0       # one bad satellite
    got = ttel.frames_from_records(recs, DetectorConfig())
    want = jtel.frames_from_records(recs, JDetectorConfig())
    for f in got._fields:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=f)
    assert float(got.residual_bad_count[1]) == 1.0
