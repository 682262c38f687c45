"""Accuracy / campaign analysis (copy of gps_jamming_tpu.utils.analysis):
TTFF, position error, clock statistics. Host NumPy; the haversine is the
port's float32 `ops.geodesy.haversine_m`, as the JAX package's.

Library re-design of the reference's offline experiment harness
(`helpers/analyze_position.py:11-50` TTFF + haversine error,
`helpers/sim.py:9-40` batch reports, `helpers/clock_error.py` /
`helpers/jitter.py` clock-bias statistics, `helpers/analiza_wielo.py` /
`wyniki/doppler.py` per-PRN series) operating on the framework's telemetry
records (runtime.telemetry schema == the reference JSON contract, so this
module also analyzes archived reference capture*.txt logs).
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from ..ops import geodesy


@dataclasses.dataclass
class PositionReport:
    ttff_s: float | None
    n_fixes: int
    mean_error_m: float
    median_error_m: float
    p95_error_m: float
    max_error_m: float
    mean_height_error_m: float
    cep50_m: float


def ttff(records: list[dict]) -> float | None:
    """Time to first fix: elapsed_time of the first record with nsat > 0
    (analyze_position.py:11-28)."""
    for r in records:
        if r["position"]["nsat"] > 0:
            return float(r["elapsed_time"])
    return None


def position_errors_m(records: list[dict], ref_lat: float, ref_lon: float,
                      ref_hgt: float | None = None):
    """Haversine horizontal error per fix record (analyze_position.py:30-50).

    Returns (errors_m, height_errors_m) arrays over records with a fix.
    """
    errs, herrs = [], []
    for r in records:
        p = r["position"]
        if p["nsat"] <= 0:
            continue
        errs.append(float(geodesy.haversine_m(
            p["lat"], p["lon"], ref_lat, ref_lon)))
        if ref_hgt is not None:
            herrs.append(p["hgt"] - ref_hgt)
    return np.asarray(errs), np.asarray(herrs)


def position_report(records: list[dict], ref_lat: float, ref_lon: float,
                    ref_hgt: float | None = None) -> PositionReport:
    """The sim.py:9-40 per-run accuracy summary."""
    errs, herrs = position_errors_m(records, ref_lat, ref_lon, ref_hgt)
    if errs.size == 0:
        return PositionReport(ttff(records), 0, np.nan, np.nan, np.nan,
                              np.nan, np.nan, np.nan)
    return PositionReport(
        ttff_s=ttff(records),
        n_fixes=int(errs.size),
        mean_error_m=float(errs.mean()),
        median_error_m=float(np.median(errs)),
        p95_error_m=float(np.percentile(errs, 95)),
        max_error_m=float(errs.max()),
        mean_height_error_m=float(herrs.mean()) if herrs.size else np.nan,
        cep50_m=float(np.median(errs)))


def clock_stats(records: list[dict]) -> dict:
    """Clock-bias statistics (clock_error.py / jitter.py): mean, std,
    drift rate (least-squares slope), and fix-to-fix jitter, in meters.
    Telemetry records carry clk_bias in seconds (the sdrout.c contract);
    converted to meters here for the reported stats."""
    c_m_s = 299_792_458.0
    t, b = [], []
    for r in records:
        p = r["position"]
        if p["nsat"] > 0:
            t.append(r["elapsed_time"])
            b.append(p["clk_bias"] * c_m_s)
    t = np.asarray(t)
    b = np.asarray(b)
    if t.size < 2:
        return {"n": int(t.size), "mean_m": float(b.mean()) if b.size else
                np.nan, "std_m": np.nan, "drift_m_per_s": np.nan,
                "jitter_m": np.nan}
    slope = np.polyfit(t, b, 1)[0]
    detr = b - np.polyval(np.polyfit(t, b, 1), t)
    return {"n": int(t.size), "mean_m": float(b.mean()),
            "std_m": float(b.std()), "drift_m_per_s": float(slope),
            "jitter_m": float(np.std(np.diff(b)))}


def per_prn_series(records: list[dict]) -> dict[int, dict[str, np.ndarray]]:
    """Per-PRN observation time series (analiza_wielo.py / doppler.py):
    prn -> {t, snr, doppler, az, el, residual}."""
    acc: dict[int, dict[str, list]] = {}
    for r in records:
        for o in r.get("observations", []):
            d = acc.setdefault(o["prn"], {k: [] for k in
                                          ("t", "snr", "doppler", "az",
                                           "el", "residual")})
            d["t"].append(r["elapsed_time"])
            d["snr"].append(o["snr"])
            d["doppler"].append(o["doppler"])
            d["az"].append(o["az"])
            d["el"].append(o["el"])
            d["residual"].append(o["residual"])
    return {prn: {k: np.asarray(v) for k, v in d.items()}
            for prn, d in acc.items()}


def load_records(path: str) -> list[dict]:
    """Load telemetry records from a JSONL log (one JSON object per line —
    both this framework's logs and the reference's capture*.txt archives)."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def batch_report(log_paths: list[str], ref_lat: float, ref_lon: float,
                 ref_hgt: float | None = None) -> list[dict]:
    """Multi-run accuracy table (the raport_zbiorczy*.xlsx role of
    helpers/sim.py, as plain dicts -> caller serializes CSV/JSON)."""
    rows = []
    for path in log_paths:
        rep = position_report(load_records(path), ref_lat, ref_lon, ref_hgt)
        row = dataclasses.asdict(rep)
        row["run"] = path
        rows.append(row)
    return rows


def export_position_csv(records: list[dict], path: str) -> int:
    """Headless-run CSV of (elapsed_time, lat, lon) fixes — the output
    contract of the reference's `helpers/get_csv.py:64-112` harness.
    Returns the number of rows written."""
    n = 0
    with open(path, "w") as f:
        f.write("elapsed_time,lat,lon\n")
        for r in records:
            p = r["position"]
            if p["nsat"] > 0:
                f.write(f"{r['elapsed_time']},{p['lat']},{p['lon']}\n")
                n += 1
    return n


def batch_report_excel(rows: list[dict], path: str) -> bool:
    """Write a batch_report() table to .xlsx (helpers/sim.py:9-40 /
    raport_zbiorczy*.xlsx parity). Returns False (and writes nothing) when
    pandas/openpyxl are unavailable — callers fall back to CSV/JSON."""
    try:
        import pandas as pd
        pd.DataFrame(rows).to_excel(path, index=False)
        return True
    except Exception:
        return False


def batch_report_csv(rows: list[dict], path: str) -> None:
    """CSV fallback for the batch accuracy table."""
    if not rows:
        with open(path, "w") as f:
            f.write("")
        return
    cols = list(rows[0].keys())
    with open(path, "w") as f:
        f.write(",".join(cols) + "\n")
        for row in rows:
            f.write(",".join(str(row[c]) for c in cols) + "\n")
