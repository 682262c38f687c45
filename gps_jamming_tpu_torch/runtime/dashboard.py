"""Live web dashboard: the GUI layer (L7) without Qt (counterpart of
gps_jamming_tpu.runtime.dashboard; the page and the HTTP surface copied,
the analysis on the port's `pipeline.analyze_capture`).

The reference couples a PySide6 main window to the analysis worker through
a loopback HTTP server on port 1234 receiving gnssdec's JSON telemetry
(worker.py:484-494 receiver, sdrout.c:10-57 sender) and renders position /
per-PRN status / jam markers on a Leaflet map (ui_mainwindow.py:737-799,
resources/map_template.html:68-190). This module provides the same surface
as a single stdlib HTTP server:

  POST /data    sdrout.c-schema telemetry record (the reference's C
                backend could post here unmodified)
  POST /event   detection/localization event records
  POST /control start/stop an analysis from the browser — the reference
                GUI's start_analysis flow (ui_mainwindow.py:653-690):
                {"action": "start", "files": [...], "system": "gps",
                 "threshold_db": 6.0, "positions": [[x, y], ...],
                 "filter": "wls", "hold": false, "max_seconds": null,
                 "receiver": true}  /  {"action": "stop"}
  GET  /state.json   full dashboard state (latest record, fix track,
                     events, per-PRN observations, triangulation,
                     antennas, running flag)
  GET  /        self-contained live page: Leaflet map (OSM / satellite /
                topo layer switcher), status panels, control form,
                antenna range circles + triangulation result panel,
                polling /state.json

No Qt/WebEngine dependency; any browser is the GUI. The `serve` CLI verb
wires an analysis thread to it for live replay of a capture, or serves
an idle landing page whose form starts analyses of server-local files.
The analysis runs on the card unless the controller is given a device;
its thread makes that card current before the first launch. A stop
raises AnalysisStopped inside the live sink, in the streaming receiver's
segment callback: the receiver drains its IO worker, closes the reader
and stops its workers on the way out, so the next start runs clean.
"""
from __future__ import annotations

import json
import math
import threading
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class DashboardState:
    """Thread-safe accumulation of telemetry + events."""

    def __init__(self, track_len: int = 5000):
        self._lock = threading.Lock()
        self.latest: dict | None = None
        self.track: deque = deque(maxlen=track_len)   # [lat, lon] fixes
        self.events: list[dict] = []
        self.records = 0
        self.status = "waiting for data"
        self.antennas: list[dict] = []      # [{x, y}] meters (settings)
        self.triangulation: dict | None = None

    def reset(self) -> None:
        """Clear per-run data (a new analysis starting from /control)."""
        with self._lock:
            self.latest = None
            self.track.clear()
            self.events.clear()
            self.records = 0
            self.triangulation = None

    def add_record(self, rec: dict) -> None:
        with self._lock:
            self.latest = rec
            self.records += 1
            pos = rec.get("position") or {}
            if pos.get("nsat", 0) >= 4 and (pos.get("lat") or pos.get("lon")):
                self.track.append([pos["lat"], pos["lon"]])
            self.status = "receiving telemetry"

    def add_event(self, ev: dict) -> None:
        with self._lock:
            self.events.append(ev)

    def set_status(self, text: str) -> None:
        with self._lock:
            self.status = text

    def set_antennas(self, positions) -> None:
        with self._lock:
            self.antennas = [{"x": float(x), "y": float(y)}
                             for x, y in (positions or [])]

    def set_triangulation(self, loc: dict | None) -> None:
        """Localization result -> map circles + result panel: per-antenna
        estimated jammer distances (the range circles of
        ui_mainwindow.py:737-816) and the grid-search position."""
        with self._lock:
            self.triangulation = loc

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "status": self.status,
                "records": self.records,
                "latest": self.latest,
                "track": list(self.track),
                "events": list(self.events),
                "antennas": list(self.antennas),
                "triangulation": self.triangulation,
            }


class AnalysisStopped(Exception):
    """Raised inside the live sink when the user POSTs a stop."""


class AnalysisController:
    """Start/stop analyses on behalf of the browser (the reference's
    start/stop buttons + progress states, ui_mainwindow.py:653-735).

    One analysis at a time; stop is cooperative — it takes effect at the
    next live telemetry emission or phase boundary."""

    def __init__(self, state: DashboardState, device=None):
        from ..device import as_device
        self.state = state
        self.device = as_device(device)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.last_params: dict | None = None

    def busy(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self, params: dict) -> tuple[bool, str]:
        import os
        if self.busy():
            return False, "analysis already running"
        files = params.get("files") or []
        if not files or not all(isinstance(f, str) for f in files):
            return False, "files: need 1-3 server-local capture paths"
        missing = [f for f in files if not os.path.exists(f)]
        if missing:
            return False, f"not found: {missing}"
        if len(files) > 3:
            return False, "at most 3 antenna captures"   # GUI limit
        sysname = params.get("system", "gps")
        if sysname not in ("gps", "glonass", "galileo"):
            return False, f"unknown system {sysname!r}"
        pos = params.get("positions")
        if pos is not None:
            try:
                pos = [(float(x), float(y)) for x, y in pos]
            except (TypeError, ValueError):
                # a malformed form entry (JS NaN -> JSON null) must be a
                # clean 409, not a post-reset server-side TypeError
                return False, ("positions: need [[x, y], ...] numeric "
                               "meters")
            if any(not (math.isfinite(x) and math.isfinite(y))
                   for x, y in pos):
                return False, "positions: non-finite coordinate"
            params = dict(params, positions=pos)
        self.last_params = dict(params)
        self._stop.clear()
        self.state.reset()
        pos = params.get("positions")
        self.state.set_antennas(pos if pos else
                                [(0.0, 0.0), (3.0, 0.0), (0.0, 3.0)]
                                [:len(files)])
        self._thread = threading.Thread(
            target=self._run, args=(dict(params),), daemon=True)
        self._thread.start()
        return True, "started"

    def stop(self) -> tuple[bool, str]:
        if not self.busy():
            return False, "no analysis running"
        self._stop.set()
        return True, "stopping"

    def join(self, timeout: float | None = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def _run(self, params: dict) -> None:
        try:
            if self.device.type == "cuda":
                import torch
                # the current device is per thread
                torch.cuda.set_device(self.device)
            replay_analysis(
                self.state, params["files"],
                system=params.get("system", "gps"),
                max_seconds=params.get("max_seconds"),
                antenna_positions=[tuple(p) for p in
                                   params["positions"]]
                if params.get("positions") else None,
                threshold_db=params.get("threshold_db"),
                pvt_filter=params.get("filter", "wls"),
                hold=bool(params.get("hold", False)),
                run_receiver=bool(params.get("receiver", True)),
                sample_rate=params.get("sample_rate"),
                realtime=bool(params.get("realtime", False)),
                stop_event=self._stop,
                emit_every_s=float(params.get("emit_every_s", 8.0)),
                device=self.device)
        except AnalysisStopped:
            self.state.set_status("stopped by user")
        except Exception as exc:              # surface, don't kill server
            self.state.set_status(f"analysis failed: {exc}")


_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>gps_jamming_tpu dashboard</title>
<link rel="stylesheet"
 href="https://unpkg.com/leaflet@1.9.4/dist/leaflet.css"/>
<script src="https://unpkg.com/leaflet@1.9.4/dist/leaflet.js"></script>
<style>
 body{margin:0;font:14px system-ui,sans-serif;display:flex;height:100vh}
 #map{flex:2}aside{flex:1;overflow:auto;padding:12px;background:#f7f7f8}
 h2{font-size:15px;margin:12px 0 4px}
 table{border-collapse:collapse;width:100%;font-size:12px}
 td,th{border:1px solid #ddd;padding:2px 5px;text-align:right}
 th{background:#eee}
 .jam{color:#fff;background:#c0392b;padding:2px 8px;border-radius:4px}
 .ok{color:#fff;background:#27ae60;padding:2px 8px;border-radius:4px}
 #ctl input,#ctl select{width:100%;box-sizing:border-box;margin:1px 0;
  font:12px monospace}
 #ctl .row{display:flex;gap:6px}#ctl .row>*{flex:1}
 #ctl button{margin-top:4px;padding:4px 10px}
 #tri{font-size:12px;background:#fff;border:1px solid #ddd;padding:6px}
 #cmsg{font-size:12px;color:#555}
</style></head><body>
<div id="map"></div>
<aside>
 <h2>Status <span id="st" class="ok">...</span></h2>
 <div id="pos"></div>
 <h2>Analysis control</h2>
 <div id="ctl">
  <input id="f0" placeholder="capture file (antenna 1, server path)">
  <input id="f1" placeholder="antenna 2 capture (optional)">
  <input id="f2" placeholder="antenna 3 capture (optional)">
  <div class="row">
   <select id="sys"><option>gps</option><option>glonass</option>
    <option>galileo</option></select>
   <select id="filt"><option>wls</option><option>ekf</option></select>
   <input id="thr" type="number" step="0.5" value="6.0"
    title="power-rise threshold dB">
  </div>
  <input id="apos" placeholder="antenna XY m: x1,y1;x2,y2;x3,y3"
   value="0,0;3,0;0,3">
  <div class="row">
   <label><input id="hold" type="checkbox"
    style="width:auto"> hold</label>
   <label><input id="rxon" type="checkbox" checked
    style="width:auto"> receiver</label>
  </div>
  <div class="row">
   <button id="bstart" onclick="ctlStart()">Start</button>
   <button id="bstop" onclick="ctlStop()">Stop</button>
  </div>
  <div id="cmsg"></div>
 </div>
 <h2>Triangulation</h2><div id="tri">no result yet</div>
 <h2>Channels</h2><table id="obs"></table>
 <h2>Events</h2><table id="ev"></table>
</aside>
<script>
let map=null,track=null,fixm=null,evms=[],antCircles=[],jamStar=null;
const CENTER=[50.06,19.94],MPDLAT=111320.0;
if (window.L){
 map=L.map('map').setView(CENTER,15);
 const osm=L.tileLayer('https://tile.openstreetmap.org/{z}/{x}/{y}.png',
   {maxZoom:19,attribution:'OSM'});
 const sat=L.tileLayer('https://server.arcgisonline.com/ArcGIS/rest/'+
   'services/World_Imagery/MapServer/tile/{z}/{y}/{x}',
   {maxZoom:19,attribution:'Esri'});
 const topo=L.tileLayer('https://{s}.tile.opentopomap.org/{z}/{x}/{y}.png',
   {maxZoom:17,attribution:'OpenTopoMap'});
 osm.addTo(map);
 L.control.layers({'OpenStreetMap':osm,'Satellite':sat,
                   'Topographic':topo}).addTo(map);
 track=L.polyline([],{color:'#2b6cb0'}).addTo(map);
}
function anchor(s){
 // antenna XY meters are mapped around the live fix (or the default
 // center) exactly like the reference's map origin (app/config.py)
 if(s.track.length) return s.track[s.track.length-1];
 return CENTER;
}
function toLL(a,x,y){
 return [a[0]+y/MPDLAT,
         a[1]+x/(MPDLAT*Math.cos(a[0]*Math.PI/180))];
}
async function ctlStart(){
 const files=[f0.value,f1.value,f2.value].filter(v=>v.trim());
 const positions=apos.value.trim()?
   apos.value.split(';').map(p=>p.split(',').map(Number)):null;
 const body={action:'start',files:files,system:sys.value,
   filter:filt.value,threshold_db:parseFloat(thr.value)||6.0,
   positions:positions&&positions.slice(0,files.length),
   hold:hold.checked,receiver:rxon.checked};
 const r=await fetch('/control',{method:'POST',
   headers:{'Content-Type':'application/json'},
   body:JSON.stringify(body)});
 cmsg.textContent=(await r.json()).message;
}
async function ctlStop(){
 const r=await fetch('/control',{method:'POST',
   headers:{'Content-Type':'application/json'},
   body:JSON.stringify({action:'stop'})});
 cmsg.textContent=(await r.json()).message;
}
async function tick(){
 try{
  const s=await (await fetch('/state.json')).json();
  const r=s.latest||{},p=r.position||{};
  const jam=s.events.some(e=>!e.end_time&&e.start_time!==undefined);
  const st=document.getElementById('st');
  st.textContent=jam?'JAMMING':(s.status||'idle');
  st.className=jam?'jam':'ok';
  document.getElementById('bstart').disabled=!!s.running;
  document.getElementById('bstop').disabled=!s.running;
  document.getElementById('pos').innerHTML=
   `records ${s.records} · t=${(r.elapsed_time||0).toFixed(1)}s · `+
   `filter ${r.filter||'-'}<br>`+
   `<b>${(p.lat||0).toFixed(6)}, ${(p.lon||0).toFixed(6)}</b> `+
   `h=${(p.hgt||0).toFixed(1)}m nsat=${p.nsat||0} `+
   `gdop=${(p.gdop||0).toFixed(2)} hold=${p.hold?1:0}`;
  const obs=r.observations||[];
  document.getElementById('obs').innerHTML=
   '<tr><th>PRN</th><th>SNR</th><th>Dopp</th><th>Az</th><th>El</th>'+
   '<th>Res</th></tr>'+obs.map(o=>`<tr><td>${o.prn}</td>`+
    `<td>${o.snr.toFixed(1)}</td><td>${o.doppler.toFixed(0)}</td>`+
    `<td>${o.az.toFixed(0)}</td><td>${o.el.toFixed(0)}</td>`+
    `<td>${o.residual.toFixed(1)}</td></tr>`).join('');
  document.getElementById('ev').innerHTML=
   '<tr><th>#</th><th>start</th><th>end</th><th>info</th></tr>'+
   s.events.map((e,i)=>`<tr><td>${i+1}</td>`+
    `<td>${(e.start_time??0).toFixed?e.start_time.toFixed(2):e.start_time}</td>`+
    `<td>${typeof e.end_time=='number'?e.end_time.toFixed(2):''}</td>`+
    `<td>${e.flags||e.reason||''}</td></tr>`)
    .join('');
  const t=s.triangulation;
  document.getElementById('tri').innerHTML=!t?'no result yet':
   !t.success?('failed: '+(t.message||'')):
   `<b>jammer at x=${t.location_meters[0].toFixed(1)} m, `+
   `y=${t.location_meters[1].toFixed(1)} m</b><br>`+
   `${t.location_geographic.lat.toFixed(6)}, `+
   `${t.location_geographic.lon.toFixed(6)}<br>`+
   `ranges: ${t.distances.map(d=>d.toFixed(1)).join(' / ')} m · `+
   `${t.num_antennas} antennas`;
  if(map){
   // a fresh /control run reset the server state: drop stale markers
   if(evms.length>s.events.length){
    evms.forEach(m=>m&&map.removeLayer(m));evms=[];
    if(jamStar){map.removeLayer(jamStar);jamStar=null;}
   }
   track.setLatLngs(s.track);
   if(s.track.length){
    const last=s.track[s.track.length-1];
    if(!fixm){fixm=L.marker(last).addTo(map);map.setView(last,15);}
    else fixm.setLatLng(last);
   }
   // antenna markers + range circles (ui_mainwindow.py:737-816)
   const a=anchor(s);
   antCircles.forEach(c=>map.removeLayer(c));antCircles=[];
   (s.antennas||[]).forEach((an,i)=>{
    const ll=toLL(a,an.x,an.y);
    antCircles.push(L.circleMarker(ll,{radius:5,color:'#2c3e50'})
      .addTo(map).bindPopup(`antenna ${i+1}`));
    if(t&&t.success&&t.distances&&t.distances[i]!==undefined)
     antCircles.push(L.circle(ll,{radius:t.distances[i],
       color:'#e67e22',weight:1,fill:false}).addTo(map));
   });
   if(t&&t.success&&!jamStar){
    jamStar=L.circleMarker(toLL(a,t.location_meters[0],
      t.location_meters[1]),{radius:10,color:'#8e44ad',weight:3})
      .addTo(map).bindPopup('triangulated jammer');
   } else if(!t&&jamStar){map.removeLayer(jamStar);jamStar=null;}
  }
  s.events.forEach((e,i)=>{
   if(map&&e.jammer_lat!==undefined&&!evms[i]){
    evms[i]=L.circleMarker([e.jammer_lat,e.jammer_lon],
      {radius:9,color:'#c0392b'}).addTo(map).bindPopup('jammer estimate');
   }});
 }catch(err){}
 setTimeout(tick,1000);
}
tick();
</script></body></html>"""


def make_server(state: DashboardState, port: int = 1234,
                host: str = "127.0.0.1",
                controller: "AnalysisController | None" = None
                ) -> ThreadingHTTPServer:
    """Bind the dashboard HTTP server (call .serve_forever() or poll
    .handle_request(); .server_address[1] is the bound port for port=0).

    controller: enables the /control start/stop surface (the serve verb
    passes one; a bare telemetry receiver may omit it)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):       # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/state.json"):
                snap = state.snapshot()
                snap["running"] = (controller.busy()
                                   if controller is not None else None)
                body = json.dumps(snap).encode()
                self._send(200, body, "application/json")
            elif self.path == "/" or self.path.startswith("/index"):
                self._send(200, _PAGE.encode(), "text/html; charset=utf-8")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                rec = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError:
                self._send(400, b"bad json", "text/plain")
                return
            if self.path.startswith("/control"):
                if controller is None:
                    self._send(403, b"no controller", "text/plain")
                    return
                action = rec.get("action")
                if action == "start":
                    ok, msg = controller.start(rec)
                elif action == "stop":
                    ok, msg = controller.stop()
                else:
                    ok, msg = False, f"unknown action {action!r}"
                body = json.dumps({"ok": ok, "message": msg}).encode()
                self._send(200 if ok else 409, body, "application/json")
            elif self.path.startswith("/event"):
                state.add_event(rec)
                self._send(200, b"OK", "text/plain")
            else:                        # /data — the sdrout.c contract
                state.add_record(rec)
                self._send(200, b"OK", "text/plain")

    return ThreadingHTTPServer((host, port), Handler)


def replay_analysis(state: DashboardState, paths, system: str = "gps",
                    max_seconds: float | None = None,
                    realtime: bool = False,
                    antenna_positions=None,
                    live: bool = True,
                    threshold_db: float | None = None,
                    pvt_filter: str = "wls",
                    hold: bool = False,
                    run_receiver: bool = True,
                    sample_rate: float | None = None,
                    stop_event: threading.Event | None = None,
                    emit_every_s: float = 8.0,
                    device=None) -> None:
    """Run the full analysis pipeline and stream its telemetry + events
    into the dashboard state (the GPSAnalysisThread role, worker.py:477).

    live (default): records are pushed into the dashboard WHILE the
    streaming receiver is still processing later segments (the gnssdec
    per-100 ms POST behavior, sdrout.c:10-57) — position and flags
    advance mid-analysis on long captures. live=False replays post-hoc.

    threshold_db / pvt_filter / hold: the settings-dialog knobs
    (settings_dialog.py:47-120) exposed to /control.
    stop_event: cooperative abort — checked at every live emission;
    raises AnalysisStopped.
    device: where the analysis runs (None: the card; raises RuntimeError
    where there is none).
    """
    import dataclasses
    import time

    from ..config import DEFAULT_CONFIG
    from . import pipeline

    cfg = DEFAULT_CONFIG
    if threshold_db is not None:
        cfg = dataclasses.replace(
            cfg, detector=dataclasses.replace(
                cfg.detector, power_rise_db=float(threshold_db)))

    state.set_status("analyzing " + ", ".join(paths))
    if antenna_positions:
        state.set_antennas(antenna_positions)
    n_live = [0]

    def sink(rec):
        if stop_event is not None and stop_event.is_set():
            raise AnalysisStopped()
        state.add_record(rec)
        n_live[0] += 1
        state.set_status(
            f"analyzing (live, t={rec['elapsed_time']:.1f}s)")

    res = pipeline.analyze_capture(
        paths, antenna_positions=antenna_positions, cfg=cfg,
        run_receiver=run_receiver, localize=True,
        max_seconds=max_seconds, system=system,
        hold=hold, pvt_filter=pvt_filter, sample_rate=sample_rate,
        sink=sink if live and not realtime else None,
        emit_every_s=emit_every_s, device=device)
    if stop_event is not None and stop_event.is_set():
        raise AnalysisStopped()
    prev_t = 0.0
    for rec in res.telemetry.records[n_live[0]:]:
        if realtime:
            time.sleep(max(rec["elapsed_time"] - prev_t, 0.0))
            prev_t = rec["elapsed_time"]
        state.add_record(rec)
    loc = getattr(res, "localization", None)
    if loc:
        state.set_triangulation(loc)
    for ev in res.events:
        ev = dict(ev)
        if loc and loc.get("success") and "location_geographic" in loc:
            g = loc["location_geographic"]
            ev.setdefault("jammer_lat", g["lat"])
            ev.setdefault("jammer_lon", g["lon"])
        state.add_event(ev)
    state.set_status("analysis complete")
