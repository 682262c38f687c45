"""Visualization exports (copy of gps_jamming_tpu.utils.viz): spectrum
waterfall, power envelope, RSSI error heatmap, per-PRN series, and a
standalone HTML map report. Host NumPy and matplotlib (Agg).

Headless (Agg) re-design of the reference's visual layer: the Welch
waterfall of `skrypty/widmo_plot.py:26-93` (P10), the chunked power plot
of `GpsJammerApp/wykres.py` (P21), the RSSI error-surface heatmap with
top-k minima of `skrypty/triangulateRSSIplot.py:64-133` (P7), the per-PRN
SNR/residual/Doppler campaign plots of `helpers/analiza_wielo.py` /
`wyniki/doppler.py` (P24), and the Leaflet map of
`resources/map_template.html` + `ui_mainwindow.py:737-799` (L7) — as file
exports with no GUI stack.
"""
from __future__ import annotations

import json

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def save_waterfall_png(spectrogram_db: np.ndarray, freq_mhz: np.ndarray,
                       chunk_seconds: float, path: str) -> None:
    """Waterfall + mean spectrum (widmo_plot.py:58-93 layout)."""
    plt = _plt()
    sg = np.asarray(spectrogram_db)
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(10, 8), sharex=True)
    ax1.imshow(sg, aspect="auto", origin="lower",
               extent=[freq_mhz[0], freq_mhz[-1],
                       0, sg.shape[0] * chunk_seconds], cmap="viridis")
    ax1.set_ylabel("time [s]")
    ax1.set_title("PSD waterfall")
    ax2.plot(freq_mhz, sg.mean(axis=0))
    ax2.set_xlabel("frequency [MHz]")
    ax2.set_ylabel("mean PSD [dB]")
    ax2.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def save_power_png(chunk_powers: np.ndarray, chunk_seconds: float,
                   threshold: float | None, events, path: str) -> None:
    """Chunk power vs time with threshold + event shading (wykres.py /
    checkIfJamming.py visual)."""
    plt = _plt()
    p = np.asarray(chunk_powers)
    t = np.arange(p.size) * chunk_seconds
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.plot(t, 10.0 * np.log10(np.maximum(p, 1e-12)), lw=0.8)
    if threshold is not None:
        ax.axhline(10.0 * np.log10(threshold), color="r", ls="--",
                   label="threshold")
    for s, e in events or []:
        ax.axvspan(s * chunk_seconds, e * chunk_seconds, color="r",
                   alpha=0.15)
    ax.set_xlabel("time [s]")
    ax.set_ylabel("chunk power [dB]")
    ax.grid(True, alpha=0.3)
    ax.legend(loc="upper right")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def save_sample_histogram_png(raw_u8: np.ndarray, path: str,
                              max_samples: int = 1 << 22) -> None:
    """Raw uint8 I/Q sample-value histogram (the ADC-headroom sanity panel
    of widmo_plot.py's figure: clipping shows as mass at 0/255, a dead
    front-end as a spike at 127/128)."""
    plt = _plt()
    v = np.asarray(raw_u8).reshape(-1)[:max_samples]
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.hist(v, bins=np.arange(257) - 0.5, color="steelblue")
    ax.set_xlabel("uint8 sample value")
    ax.set_ylabel("count")
    ax.set_title("I/Q sample distribution")
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def save_rssi_heatmap_png(err: np.ndarray, xs: np.ndarray, ys: np.ndarray,
                          antennas, best_xy, minima, path: str) -> None:
    """Log-scaled error surface + antennas + top minima
    (triangulateRSSIplot.py:64-133)."""
    plt = _plt()
    from matplotlib.colors import LogNorm
    err = np.asarray(err)
    fig, ax = plt.subplots(figsize=(8, 7))
    im = ax.pcolormesh(np.asarray(xs), np.asarray(ys), err,
                       norm=LogNorm(), cmap="hot_r", shading="auto")
    fig.colorbar(im, ax=ax, label="sum |dist - r| [m]")
    for i, (x, y) in enumerate(antennas):
        ax.plot(x, y, "b^", ms=10)
        ax.annotate(f"A{i}", (x, y), textcoords="offset points",
                    xytext=(5, 5), color="b")
    for x, y in minima or []:
        ax.plot(x, y, "wo", mec="k", ms=6)
    ax.plot(best_xy[0], best_xy[1], "r*", ms=16, mec="k")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_title("RSSI grid-search error surface")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def save_prn_series_png(series: dict, path: str,
                        fields=("snr", "doppler", "residual", "el")) -> None:
    """Per-PRN time series panels (analiza_wielo.py / doppler.py)."""
    plt = _plt()
    fig, axes = plt.subplots(len(fields), 1, figsize=(10, 2.6 * len(fields)),
                             sharex=True)
    if len(fields) == 1:
        axes = [axes]
    for ax, f in zip(axes, fields):
        for prn, d in sorted(series.items()):
            ax.plot(d["t"], d[f], lw=0.9, label=f"PRN {prn}")
        ax.set_ylabel(f)
        ax.grid(True, alpha=0.3)
    axes[0].legend(ncol=6, fontsize=7, loc="upper right")
    axes[-1].set_xlabel("elapsed time [s]")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


_MAP_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>GPS jamming report</title>
<link rel="stylesheet"
 href="https://unpkg.com/leaflet@1.9.4/dist/leaflet.css"/>
<script src="https://unpkg.com/leaflet@1.9.4/dist/leaflet.js"></script>
<style>
 body {{ margin: 0; font-family: sans-serif; }}
 #map {{ height: 70vh; }}
 #panel {{ padding: 12px 16px; }}
 table {{ border-collapse: collapse; }}
 td, th {{ border: 1px solid #ccc; padding: 4px 10px; font-size: 13px; }}
</style></head><body>
<div id="map"></div>
<div id="panel">
<h3>Detection events</h3>
<table><tr><th>#</th><th>start [s]</th><th>end [s]</th><th>flags</th></tr>
{event_rows}
</table>
<h3>Localization</h3>
<pre>{loc_text}</pre>
</div>
<script>
var data = {data_json};
var map = L.map('map').setView(data.center, 16);
L.tileLayer('https://tile.openstreetmap.org/{{z}}/{{x}}/{{y}}.png',
            {{maxZoom: 19}}).addTo(map);
if (data.track.length > 1) {{
  L.polyline(data.track, {{color: 'blue'}}).addTo(map);
}}
if (data.last_fix) {{
  L.marker(data.last_fix).addTo(map).bindPopup('last safe fix');
}}
if (data.jammer) {{
  L.circleMarker(data.jammer, {{radius: 10, color: 'red'}})
   .addTo(map).bindPopup('estimated jammer');
}}
for (const a of data.antennas) {{
  L.circleMarker(a, {{radius: 5, color: 'green'}}).addTo(map);
}}
</script></body></html>
"""


def save_map_report_html(path: str, track_lla=(), last_fix=None,
                         jammer_lla=None, antennas_lla=(), events=(),
                         localization=None) -> None:
    """Self-contained Leaflet HTML report (map_template.html:68-190 +
    ui_mainwindow.py marker/polyline injection roles). Track/fix/jammer
    points are (lat, lon) pairs; renders offline except map tiles."""
    track = [[float(a), float(b)] for a, b in track_lla]
    if last_fix is not None:
        last_fix = [float(last_fix[0]), float(last_fix[1])]
    if jammer_lla is not None:
        jammer_lla = [float(jammer_lla[0]), float(jammer_lla[1])]
    ants = [[float(a), float(b)] for a, b in antennas_lla]
    center = (last_fix or jammer_lla or (track[-1] if track else None)
              or (ants[0] if ants else [50.06, 19.94]))
    rows = []
    for i, ev in enumerate(events):
        flags = ev.get("flags", ev.get("reason", ""))
        rows.append(f"<tr><td>{i + 1}</td>"
                    f"<td>{ev.get('start_time', 0):.2f}</td>"
                    f"<td>{ev.get('end_time', 0):.2f}</td>"
                    f"<td>{flags}</td></tr>")
    html = _MAP_TEMPLATE.format(
        event_rows="\n".join(rows) or "<tr><td colspan=4>none</td></tr>",
        loc_text=json.dumps(localization, indent=2, default=str)
        if localization else "n/a",
        data_json=json.dumps({
            "center": center, "track": track, "last_fix": last_fix,
            "jammer": jammer_lla, "antennas": ants}))
    with open(path, "w") as f:
        f.write(html)
