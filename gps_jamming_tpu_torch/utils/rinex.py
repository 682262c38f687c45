"""RINEX 2 GPS navigation file reader/writer (copy of
gps_jamming_tpu.utils.rinex, on the port's `lnav.Ephemeris` and
`gpstime`).

Input parity with the reference's ephemeris corpus: `data/sim_data/
brdc2830.25n` and the `*_fake_PRN.25n` spoof variants feed gps-sdr-sim
(gnss_frontend.py:961-999, README.md:40-47); this module reads the same
files into `lnav.Ephemeris` records so the framework's own simulator
(sim.constellation) can render captures from real broadcast orbits, and
writes them back for fixture generation (the spoof-ephemeris workflow).
"""
from __future__ import annotations

from ..models.receiver.lnav import Ephemeris
from . import gpstime

_FIELDS_PER_LINE = 4


def _f(s: str) -> float:
    """RINEX float: D/d exponents, embedded blanks."""
    s = s.strip().replace("D", "E").replace("d", "E")
    return float(s) if s else 0.0


def _split_record_line(line: str, first: bool = False) -> list[float]:
    """Fixed 19-char fields starting at col 3 (record) / col 22 (line 1)."""
    out = []
    start = 22 if first else 3
    for i in range(3 if first else 4):
        out.append(_f(line[start + 19 * i: start + 19 * (i + 1)]))
    return out


def read_nav(path: str) -> list[Ephemeris]:
    """Parse a RINEX 2.x GPS nav file -> Ephemeris records.

    Sets have_subframes=(1, 2, 3) (a broadcast record IS a full frame).
    toc/toe are seconds of week; week is the full GPS week from the toc
    epoch (no 10-bit truncation).
    """
    with open(path) as fh:
        lines = fh.read().splitlines()
    i = 0
    while i < len(lines):
        if "END OF HEADER" in lines[i]:
            i += 1
            break
        i += 1
    else:
        i = 0                                   # headerless fragment
    out = []
    while i + 7 < len(lines):
        l1 = lines[i]
        if len(l1.strip()) == 0:
            i += 1
            continue
        prn = int(l1[0:2])
        yy = int(l1[3:5])
        year = yy + (2000 if yy < 80 else 1900)
        mo, dd, hh, mi = (int(l1[6:8]), int(l1[9:11]), int(l1[12:14]),
                          int(l1[15:17]))
        sec = _f(l1[17:22])
        week_toc, toc = gpstime.calendar_to_week_tow(year, mo, dd, hh, mi,
                                                     sec)
        af0, af1, af2 = _split_record_line(l1, first=True)
        r = [_split_record_line(lines[i + k]) for k in range(1, 8)]
        eph = Ephemeris(
            prn=prn, week=week_toc, toc=toc,
            af0=af0, af1=af1, af2=af2,
            iode=int(r[0][0]), crs=r[0][1], delta_n=r[0][2], m0=r[0][3],
            cuc=r[1][0], e=r[1][1], cus=r[1][2], sqrt_a=r[1][3],
            toe=r[2][0], cic=r[2][1], omega0=r[2][2], cis=r[2][3],
            i0=r[3][0], crc=r[3][1], omega=r[3][2], omega_dot=r[3][3],
            idot=r[4][0], tgd=r[5][2], iodc=int(r[5][3]),
            ura=int(r[5][0]), health=int(r[5][1]),
            have_subframes=(1, 2, 3))
        # broadcast week on line 6 field 3 is the toe week; prefer it when
        # present (handles toc/toe week straddle)
        wk = int(r[4][2])
        if wk > 0:
            eph.week = wk
        out.append(eph)
        i += 8
    return out


def _fmt(x: float) -> str:
    """RINEX 2 D-exponent field, 19 chars."""
    s = f"{x: 19.12E}"
    mant, expo = s.split("E")
    return f"{mant}D{int(expo):+03d}"


def write_nav(path: str, ephs: list[Ephemeris]) -> None:
    """Write RINEX 2 GPS nav (enough for read_nav round-trip and for
    external gps-sdr-sim-style consumers)."""
    hdr = (f"{'2':>9}{'':11}{'N: GPS NAV DATA':<40}RINEX VERSION / TYPE\n"
           f"{'gps_jamming_tpu':<20}{'':40}PGM / RUN BY / DATE\n"
           f"{'':60}END OF HEADER\n")
    body = []
    for e in ephs:
        t = gpstime.week_tow_to_calendar(e.week, e.toc)
        l1 = (f"{e.prn:2d} {t.year % 100:02d} {t.month:2d} {t.day:2d}"
              f" {t.hour:2d} {t.minute:2d}{t.second + 0.0:5.1f}"
              f"{_fmt(e.af0)}{_fmt(e.af1)}{_fmt(e.af2)}")
        rows = [
            (e.iode, e.crs, e.delta_n, e.m0),
            (e.cuc, e.e, e.cus, e.sqrt_a),
            (e.toe, e.cic, e.omega0, e.cis),
            (e.i0, e.crc, e.omega, e.omega_dot),
            (e.idot, 0.0, float(e.week), 0.0),
            (float(e.ura), float(e.health), e.tgd, float(e.iodc)),
            (e.toe, 4.0, 0.0, 0.0),
        ]
        body.append(l1)
        for row in rows:
            body.append("   " + "".join(_fmt(float(v)) for v in row))
    with open(path, "w") as fh:
        fh.write(hdr + "\n".join(body) + "\n")
