"""Command line of the port (counterpart of gps_jamming_tpu.cli's
detect, localize, calibrate and receiver verbs):

    python -m gps_jamming_tpu_torch detect a0.bin a1.bin a2.bin
    python -m gps_jamming_tpu_torch detect cap.bin --checkpoint d.ckpt
    python -m gps_jamming_tpu_torch localize a0.bin a1.bin a2.bin
    python -m gps_jamming_tpu_torch calibrate capture.bin
    python -m gps_jamming_tpu_torch receiver capture.bin [--streaming]

The verbs take the JAX package's flags and print its JSON keys. Each runs
on the card unless `--device` names another device (`--device cpu`).
`detect` runs the streaming receiver unless `--batch-receiver` (or
`--no-receiver`) is given; `receiver --streaming` runs it over segments
of `--segment-seconds`. `--system` takes the JAX CLI's systems (GPS,
Galileo, GLONASS; `receiver` also SBAS, whose messages it prints).
`--devices` (the sharded analysis, ROADMAP A8) is not ported yet and exits
with status 2.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _wire_bits(s: str):
    """argparse type for --wire-bits: 'auto' or an int width."""
    return s if s == "auto" else int(s)


def _parse_positions(spec: str | None, n: int):
    """--positions "x1,y1;x2,y2;..." -> [(x, y), ...]."""
    if spec is None:
        # default antenna square (settings_dialog.py defaults)
        return [(0.0, 0.0), (3.0, 0.0), (0.0, 3.0)][:n]
    out = []
    for part in spec.split(";"):
        x, y = part.split(",")
        out.append((float(x), float(y)))
    return out


def _config_with_overrides(args):
    """Apply settings-dialog-style CLI overrides (settings_dialog.py:47-120)
    onto the default config tree."""
    import dataclasses

    from .config import DEFAULT_CONFIG
    cfg = DEFAULT_CONFIG
    thr = getattr(args, "threshold_db", None)
    if thr is not None:
        cfg = dataclasses.replace(
            cfg, detector=dataclasses.replace(cfg.detector,
                                              power_rise_db=float(thr)))
    return cfg


def _refuse(verb: str, refused: list[tuple[str, str]]) -> int:
    """Print what `verb` cannot run yet, by ROADMAP item, and return 2."""
    for flags, item in refused:
        print(f"{verb}: {flags} needs {item}, which is not ported yet",
              file=sys.stderr)
    return 2


A8 = "ROADMAP A8 (multi-device)"


def _device(args):
    from .device import as_device
    return as_device(args.device)


def cmd_detect(args) -> int:
    if args.devices:
        return _refuse("detect", [("--devices", A8)])
    from .runtime import pipeline
    positions = _parse_positions(args.positions, len(args.files))
    res = pipeline.analyze_capture(
        args.files, antenna_positions=positions,
        cfg=_config_with_overrides(args),
        run_receiver=not args.no_receiver, localize=not args.no_localize,
        max_seconds=args.max_seconds, system=args.system, hold=args.hold,
        sample_rate=args.sample_rate, pvt_filter=args.filter,
        streaming=not args.batch_receiver, wire_bits=args.wire_bits,
        checkpoint_path=args.checkpoint, resume=args.resume,
        device=_device(args))
    out = {
        "power_ranges_bytes": res.power_ranges,
        "events": res.events,
        "n_events": len(res.events),
        "localization": res.localization,
        "tdoa": {k: v for k, v in (res.tdoa_result or {}).items()
                 if k != "onsets"} if res.tdoa_result else None,
        "last_safe_fix": res.last_safe_fix,
        "elapsed_s": round(res.elapsed_s, 2),
    }
    if res.receiver is not None:
        fix = res.receiver.best_fix
        out["fix"] = None if fix is None else {
            "lat": fix.lat_deg, "lon": fix.lon_deg, "hgt": fix.height_m,
            "gdop": fix.gdop, "nsat": fix.nsat}
        out["acquired_prns"] = [c.prn for c in res.receiver.channels
                                if c.acquired]
    print(json.dumps(out, default=_np_default, indent=2))
    if args.telemetry_out:
        res.telemetry.save_jsonl(args.telemetry_out)
    return 0


def cmd_localize(args) -> int:
    from .config import DEFAULT_CONFIG as CFG
    from .models import rssi, tdoa
    from .ops import iq
    dev = _device(args)
    positions = _parse_positions(args.positions, len(args.files))
    caps = [iq.read_iq_file(p, convention="normalized") for p in args.files]
    out = {"rssi": rssi.triangulate(caps, positions, cfg=CFG.rssi,
                                    device=dev)}
    del caps
    if not args.no_tdoa and len(args.files) >= 2:
        td = tdoa.localize(
            [iq.read_iq_file(p, convention="centered") for p in args.files],
            positions, args.sample_rate or CFG.frontend.sample_rate_hz,
            cfg=CFG.tdoa, device=dev)
        td.pop("onsets", None)
        out["tdoa"] = td
    print(json.dumps(out, default=_np_default, indent=2))
    return 0


def cmd_calibrate(args) -> int:
    import torch

    from .config import DEFAULT_CONFIG as CFG
    from .models import detector
    from .ops import iq
    x = torch.from_numpy(iq.read_iq_file(args.file, convention="centered"))
    pm = detector.standalone_chunk_powers(x.to(_device(args)), CFG.detector)
    thr = float(detector.calibrate_threshold(pm))
    ev = detector.standalone_events(pm, thr,
                                    CFG.detector.standalone_chunk_bytes // 2)
    print(json.dumps({"suggested_threshold": thr,
                      "median_power": thr / CFG.detector.calibration_factor,
                      "events_at_threshold": ev}, default=_np_default))
    return 0


def cmd_receiver(args) -> int:
    import torch

    from .models.receiver import receiver as rx_mod
    from .ops import iq
    from .runtime import telemetry
    if args.streaming:
        # bounded device memory: a segment window whatever the capture's
        # length
        from .runtime import rx_stream
        srx = rx_stream.StreamingReceiver(
            args.sample_rate, system=args.system,
            segment_s=args.segment_seconds, pvt_filter=args.filter,
            device=_device(args))
        res = srx.process_file(
            args.file, convention="centered",
            max_samples=(None if args.max_seconds is None
                         else int(args.max_seconds * args.sample_rate)),
            checkpoint_path=args.checkpoint, resume=args.resume,
            wire_bits=args.wire_bits)
    else:
        x = iq.read_iq_file(args.file, convention="centered",
                            count=(int(args.max_seconds * args.sample_rate)
                                   * 2 if args.max_seconds else -1))
        res = rx_mod.run_receiver(torch.from_numpy(x).to(_device(args)),
                                  args.sample_rate, system=args.system,
                                  pvt_filter=args.filter)
    fix = res.best_fix
    held = False
    if args.hold and fix is not None:
        # gnssdec -h: run every valid fix through the hold filter and
        # report the (possibly frozen) final position (sdrout.c:141-183)
        filt = telemetry.HoldPositionFilter()
        lat, lon, hgt = fix.lat_deg, fix.lon_deg, fix.height_m
        for f in res.fixes:
            if f.valid:
                lat, lon, hgt, held = filt.apply(f.lat_deg, f.lon_deg,
                                                 f.height_m)
        fix = fix._replace(lat_deg=lat, lon_deg=lon, height_m=hgt)
    out = {
        "acquired": [
            {"prn": c.prn, "doppler_hz": round(c.doppler_hz, 1),
             "peak_ratio": round(c.peak_ratio, 2),
             "cn0_dbhz": round(c.cn0_dbhz, 1)}
            for c in res.channels if c.acquired],
        "decoded_prns": [c.prn for c in res.channels
                         if c.obs is not None
                         and rx_mod._eph_complete(args.system, c.obs.eph)],
        "messages": [
            {"prn": c.prn, "mt": m.mt, "tow_s": m.tow_s, "week": m.week}
            for c in res.channels for m in (c.messages or [])],
        "filter": res.filter_name,
        "n_fixes": len([f for f in res.fixes if f.valid]),
        "fix": None if fix is None else {
            "lat": fix.lat_deg, "lon": fix.lon_deg, "hgt": fix.height_m,
            "gdop": fix.gdop, "clk_bias_m": fix.clock_bias_m,
            "nsat": fix.nsat, "hold": held},
    }
    print(json.dumps(out, default=_np_default, indent=2))
    return 0


def _np_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.bool_,)):
        return bool(o)
    raise TypeError(f"not JSON serializable: {type(o)}")


def _add_device(p):
    p.add_argument("--device",
                   help="torch device to run on (default: the card; "
                        "'cpu' runs the plain versions on the CPU)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gps_jamming_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("detect", help="full detection pipeline on captures")
    d.add_argument("files", nargs="+")
    d.add_argument("--positions", help='"x1,y1;x2,y2;..." antenna XY [m]')
    d.add_argument("--no-receiver", action="store_true")
    d.add_argument("--no-localize", action="store_true")
    d.add_argument("--max-seconds", type=float)
    d.add_argument("--telemetry-out", help="write JSONL telemetry here")
    d.add_argument("--system", default="gps",
                   choices=["gps", "glonass", "galileo"],
                   help="constellation (the reference's -g/-l/-a modes)")
    d.add_argument("--threshold-db", type=float,
                   help="F1 power-rise threshold over baseline "
                        "(settings dialog; default 6.0 dB ITU-R)")
    d.add_argument("--hold", action="store_true",
                   help="freeze reported position on >1 deg jumps "
                        "(the reference's -h flag)")
    d.add_argument("--sample-rate", type=float,
                   help="capture rate [Hz]; default = per-system "
                        "(2.048e6 GPS/Galileo, 10e6 GLONASS)")
    d.add_argument("--filter", default="wls", choices=["wls", "ekf"],
                   help="PVT filter: wls (blsFilter parity) or ekf")
    d.add_argument("--batch-receiver", action="store_true",
                   help="the acquire-once whole-capture receiver "
                        "(default: the streaming receiver)")
    d.add_argument("--wire-bits", type=_wire_bits, default="auto",
                   choices=["auto", 8, 4, 2, 1],
                   help="streaming receiver upload width: auto = 2-bit "
                        "above 10 MB/s of raw bytes, else 8-bit")
    d.add_argument("--checkpoint",
                   help="streaming detect checkpoint file (the receiver's "
                        "state goes to <file>.rx)")
    d.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint")
    d.add_argument("--devices", type=int,
                   help="sharded analysis over N devices (ROADMAP A8)")
    _add_device(d)
    d.set_defaults(fn=cmd_detect)

    loc = sub.add_parser("localize", help="RSSI + TDOA localization")
    loc.add_argument("files", nargs="+")
    loc.add_argument("--positions")
    loc.add_argument("--no-tdoa", action="store_true")
    loc.add_argument("--sample-rate", type=float,
                     help="capture rate [Hz], default 2.048e6 (TDOA lags)")
    _add_device(loc)
    loc.set_defaults(fn=cmd_localize)

    c = sub.add_parser("calibrate", help="standalone threshold calibration")
    c.add_argument("file")
    _add_device(c)
    c.set_defaults(fn=cmd_calibrate)

    r = sub.add_parser("receiver", help="GNSS receiver chain -> PVT fix")
    r.add_argument("file")
    r.add_argument("--sample-rate", type=float, default=2.048e6)
    r.add_argument("--max-seconds", type=float)
    r.add_argument("--system", default="gps",
                   choices=["gps", "glonass", "galileo", "sbas"],
                   help="constellation (SBAS: message monitoring)")
    r.add_argument("--hold", action="store_true",
                   help="hold-position output filter (gnssdec -h)")
    r.add_argument("--streaming", action="store_true",
                   help="the segmented, self-healing receiver")
    r.add_argument("--segment-seconds", type=float, default=4.0,
                   help="streaming segment length")
    r.add_argument("--checkpoint",
                   help="streaming receiver checkpoint file")
    r.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint")
    r.add_argument("--wire-bits", type=_wire_bits, default="auto",
                   choices=["auto", 8, 4, 2, 1],
                   help="streaming upload width")
    r.add_argument("--filter", default="wls", choices=["wls", "ekf"],
                   help="PVT filter: wls (blsFilter parity) or ekf")
    _add_device(r)
    r.set_defaults(fn=cmd_receiver)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
