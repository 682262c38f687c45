"""Telemetry records: the reference's JSON contract + hold-position filter
(the port's copy of gps_jamming_tpu.runtime.telemetry, host code).

Schema-compatible with the gnssdec JSON POST (`sdrout.c:213-325`):
{elapsed_time, time, filter, acq_sv[], tracked[], decoded[],
 position{nsat, lat, lon, hgt, gdop, clk_bias, buffcnt, hold},
 observations[{prn, tow, week, snr, doppler, az, el, residual,
 innovation}]}
so the reference's analysis scripts (helpers/get_csv.py,
helpers/analyze_position.py, analiza_wielo.py) work unchanged against this
framework's output. Records are plain dicts the caller streams to disk
or a callback; `HttpSink` is the callback that POSTs them to a loopback
endpoint, as gnssdec does (sdrout.c:10-57), for the live dashboard.
"""
from __future__ import annotations

import dataclasses
import json
import re

import numpy as np

from ..utils import gpstime


def format_gps_time(week: int, tow_s: float, clk_bias_s: float = 0.0) -> str:
    """GPS (week, tow) -> the reference's UTC time string
    "YYYY-MM-DD HH:MM:SS.mmm" (sdrout.c:205-212). Reference quirk kept:
    the whole seconds include the clock-bias correction but the
    milliseconds come from the raw tow (`(int)(gps_tow*1000)%1000`)."""
    utc = gpstime.gpst_to_utc(week, tow_s + clk_bias_s)
    ms = int(tow_s * 1000) % 1000
    return (f"{utc.year:04d}-{utc.month:02d}-{utc.day:02d} "
            f"{utc.hour:02d}:{utc.minute:02d}:{utc.second:02d}.{ms:03d}")


@dataclasses.dataclass
class HoldPositionFilter:
    """Freeze the reported fix when it jumps > `jump_deg` from the last
    good one (sdrout.c:141-183, enabled by the reference's -h flag)."""
    jump_deg: float = 1.0
    enabled: bool = True
    _last: tuple | None = None
    holding: bool = False

    def apply(self, lat: float, lon: float, hgt: float):
        """Returns (lat, lon, hgt, holding)."""
        if not self.enabled:
            return lat, lon, hgt, False
        if self._last is None:
            self._last = (lat, lon, hgt)
            self.holding = False
            return lat, lon, hgt, False
        dlat = abs(lat - self._last[0])
        dlon = abs(lon - self._last[1])
        if dlat > self.jump_deg or dlon > self.jump_deg:
            self.holding = True
            return (*self._last, True)
        self._last = (lat, lon, hgt)
        self.holding = False
        return lat, lon, hgt, False


_C_M_S = 299_792_458.0


def make_record(elapsed_s: float, time_s: float, buffcnt: int,
                acq_prns=(), tracked_prns=(), decoded_prns=(),
                fix=None, observations=(), hold: bool = False,
                filter_name: str = "WLS", week: int = 0) -> dict:
    """Build one sdrout.c-schema telemetry record.

    fix: PvtSolution-like (lat_deg, lon_deg, height_m, gdop, clock_bias_m,
    nsat) or None before first fix. `time_s` is the GPS time of week (the
    record's "time" field is the reference's formatted UTC string;
    week 0 / tow 0 renders the epoch "1980-01-06 00:00:00.000" exactly as
    gnssdec does before the first decode). clk_bias is emitted in seconds
    (sdrout.c's clkBias/CTIME), not meters.
    """
    clk_s = (float(getattr(fix, "clock_bias_m", 0.0)) / _C_M_S
             if fix is not None else 0.0)
    pos = {
        "nsat": int(getattr(fix, "nsat", 0)) if fix is not None else 0,
        "lat": float(getattr(fix, "lat_deg", 0.0)) if fix is not None else 0.0,
        "lon": float(getattr(fix, "lon_deg", 0.0)) if fix is not None else 0.0,
        "hgt": float(getattr(fix, "height_m", 0.0)) if fix is not None else 0.0,
        "gdop": float(getattr(fix, "gdop", 0.0)) if fix is not None else 0.0,
        "clk_bias": clk_s,
        "buffcnt": int(buffcnt),
        "hold": bool(hold),
    }
    return {
        "elapsed_time": float(elapsed_s),
        "time": format_gps_time(week, float(time_s), clk_s)
        if not isinstance(time_s, str) else time_s,
        "filter": filter_name,
        "acq_sv": [int(p) for p in acq_prns],
        "tracked": [int(p) for p in tracked_prns],
        "decoded": [int(p) for p in decoded_prns],
        "position": pos,
        "observations": [dict(o) for o in observations],
    }


def make_observation(prn: int, tow: float, week: int, snr: float,
                     doppler: float, az: float, el: float,
                     residual: float, innovation: float = 0.0) -> dict:
    return {"prn": int(prn), "tow": float(tow), "week": int(week),
            "snr": float(snr), "doppler": float(doppler),
            "az": float(az), "el": float(el),
            "residual": float(residual), "innovation": float(innovation)}


def format_status_line(rec: dict) -> str:
    """Pipe-delimited status text, byte-exact with the gnssdec stdout
    grammar (sdrout.c:218-323; golden example backend/bin/logi.txt):

        ETIME|%.3f
        TIME|YYYY-MM-DD HH:MM:SS.mmm
        FILTER|WLS
        ACQSV|%02d %02d ...     (trailing space when non-empty)
        TRACKED|... / DECODED|...
        LLA|%02d|%.7f|%.7f|%.1f|%.2f|%.5e|%llu   (clk_bias in seconds)
        OBS|%02d|%.1f|%d|%.1f|%.1f|%05.1f|%04.1f|%05.1f|%7.1f  per sat
    """
    p = rec["position"]
    t = rec["time"]
    if not isinstance(t, str):
        t = format_gps_time(0, float(t))

    def svlist(key):
        return "".join(f"{int(x):02d} " for x in rec[key])

    parts = [
        f"ETIME|{rec['elapsed_time']:.3f}",
        f"TIME|{t}",
        f"FILTER|{rec['filter']}",
        "ACQSV|" + svlist("acq_sv"),
        "TRACKED|" + svlist("tracked"),
        "DECODED|" + svlist("decoded"),
        (f"LLA|{p['nsat']:02d}|{p['lat']:.7f}|{p['lon']:.7f}|"
         f"{p['hgt']:.1f}|{p['gdop']:.2f}|{p['clk_bias']:.5e}|"
         f"{int(p['buffcnt'])}"),
    ]
    for o in rec["observations"]:
        parts.append(
            f"OBS|{int(o['prn']):02d}|{o['tow']:.1f}|{int(o['week'])}|"
            f"{o['snr']:.1f}|{o['doppler']:.1f}|{o['az']:05.1f}|"
            f"{o['el']:04.1f}|{o['residual']:05.1f}|{o['innovation']:7.1f}")
    return "\n".join(parts)


def parse_status_lines(text: str) -> list[dict]:
    """Parse a gnssdec pipe-format stdout stream (logi.txt grammar) back
    into telemetry records — the inverse of format_status_line. Non-grammar
    lines (e.g. the "GNSS-SDRLIB start!" banner) are skipped."""
    recs: list[dict] = []
    rec: dict | None = None

    def svparse(s: str) -> list[int]:
        return [int(x) for x in s.split()]

    for line in text.splitlines():
        if "|" not in line:
            continue
        tag, _, rest = line.partition("|")
        if tag == "ETIME":
            if rec is not None:
                recs.append(rec)
            rec = {"elapsed_time": float(rest), "time": "", "filter": "WLS",
                   "acq_sv": [], "tracked": [], "decoded": [],
                   "position": {"nsat": 0, "lat": 0.0, "lon": 0.0,
                                "hgt": 0.0, "gdop": 0.0, "clk_bias": 0.0,
                                "buffcnt": 0, "hold": False},
                   "observations": []}
        elif rec is None:
            continue
        elif tag == "TIME":
            rec["time"] = rest
        elif tag == "FILTER":
            rec["filter"] = rest
        elif tag == "ACQSV":
            rec["acq_sv"] = svparse(rest)
        elif tag == "TRACKED":
            rec["tracked"] = svparse(rest)
        elif tag == "DECODED":
            rec["decoded"] = svparse(rest)
        elif tag == "LLA":
            f = rest.split("|")
            rec["position"].update(
                nsat=int(f[0]), lat=float(f[1]), lon=float(f[2]),
                hgt=float(f[3]), gdop=float(f[4]), clk_bias=float(f[5]),
                buffcnt=int(f[6]))
        elif tag == "OBS":
            f = rest.split("|")
            rec["observations"].append(
                {"prn": int(f[0]), "tow": float(f[1]), "week": int(f[2]),
                 "snr": float(f[3]), "doppler": float(f[4]),
                 "az": float(f[5]), "el": float(f[6]),
                 "residual": float(f[7]), "innovation": float(f[8])})
    if rec is not None:
        recs.append(rec)
    return recs


_CORPUS_BLOCK_RE = re.compile(r"\[([^\]\n]*)\]\s*(\{.*)", re.S)


def parse_reference_log(text: str) -> list[tuple[str, dict]]:
    """Parse an archived telemetry campaign log (the reference's
    helpers/wyniki/ capture*.txt format, written by the port-1234 JSON
    logger helpers/test_http_server.py:15-60): blocks separated by
    `====...` rules, each `[local timestamp]` + pretty-printed JSON.
    Returns [(timestamp_str, record), ...]."""
    out: list[tuple[str, dict]] = []
    for block in re.split(r"={10,}", text):
        block = block.strip()
        if not block:
            continue
        m = _CORPUS_BLOCK_RE.match(block)
        if m is None:
            continue
        out.append((m.group(1), json.loads(m.group(2))))
    return out


def frames_from_records(records: list[dict], cfg) -> "object":
    """Telemetry records -> detector.TelemetryFrames, mirroring the
    per-record state extraction of the reference GUI worker
    (process_incoming_data, worker.py:277-361): C/N0 = mean of the
    observations' snr (0 when none), residual median + count of sats above
    the single-sat threshold, height/nsat from the position block,
    time = elapsed_time, buffcnt = capture byte offset (int64)."""
    from ..models import detector as _det
    n = len(records)
    t = np.zeros(n, np.float64)
    buff = np.zeros(n, np.int64)
    cn0 = np.zeros(n, np.float32)
    res_med = np.zeros(n, np.float32)
    bad = np.zeros(n, np.float32)
    hgt = np.zeros(n, np.float32)
    nsat = np.zeros(n, np.float32)
    for i, r in enumerate(records):
        pos = r.get("position", {})
        obs = r.get("observations", [])
        t[i] = float(r.get("elapsed_time", 0.0))
        buff[i] = int(pos.get("buffcnt", 0))
        snrs = [o.get("snr", 0.0) for o in obs if "snr" in o]
        if snrs:
            cn0[i] = float(np.mean(snrs))
            resid = [o.get("residual", 0.0) for o in obs if "residual" in o]
            if resid:
                res_med[i] = float(np.median(resid))
                bad[i] = sum(1 for x in resid
                             if x > cfg.residual_single_sat_m)
        hgt[i] = float(pos.get("hgt", 0.0))
        nsat[i] = float(pos.get("nsat", 0))
    return _det.TelemetryFrames(time_s=t, buffcnt=buff, cn0_avg=cn0,
                                residual_median=res_med,
                                residual_bad_count=bad, hgt=hgt, nsat=nsat)


class TelemetryLog:
    """Append-only record log with JSONL persistence (the role of the
    helpers' capture*.txt archives, helpers/wyniki/)."""

    def __init__(self):
        self.records: list[dict] = []

    def append(self, rec: dict) -> None:
        self.records.append(rec)

    def save_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for r in self.records:
                f.write(json.dumps(r) + "\n")

    @staticmethod
    def load_jsonl(path: str) -> "TelemetryLog":
        log = TelemetryLog()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    log.records.append(json.loads(line))
        return log

    def to_csv_rows(self) -> list[tuple[float, float, float]]:
        """(elapsed_time, lat, lon) rows — the get_csv.py:64-112 contract."""
        return [(r["elapsed_time"], r["position"]["lat"],
                 r["position"]["lon"]) for r in self.records
                if r["position"]["nsat"] > 0]


class HttpSink:
    """POST each record as JSON to a loopback endpoint: wire parity with
    gnssdec's socket POST to http://127.0.0.1:1234/data (sdrout.c:10-57),
    so reference-side consumers (the GUI's receiver worker.py:24, the
    headless harness helpers/get_csv.py, helpers/test_http_server.py) and
    the port's dashboard work unchanged against this framework.
    """

    def __init__(self, url: str = "http://127.0.0.1:1234/data",
                 timeout_s: float = 1.0):
        self.url = url
        self.timeout_s = timeout_s
        self.sent = 0
        self.errors = 0

    def __call__(self, rec: dict) -> bool:
        import urllib.error
        import urllib.request
        body = json.dumps(rec).encode()
        req = urllib.request.Request(
            self.url, data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s):
                pass
            self.sent += 1
            return True
        except (urllib.error.URLError, OSError):
            self.errors += 1
            return False

    def post_all(self, log: "TelemetryLog") -> int:
        return sum(1 for r in log.records if self(r))
