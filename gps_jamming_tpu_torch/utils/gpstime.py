"""GPS time conversions: calendar <-> (week, tow), GPS <-> UTC leap seconds
(the port's copy of gps_jamming_tpu.utils.gpstime).

Host-side re-design of the reference's time plumbing: the GPS->UTC
leap-second table of `sdrcmn.c:775-811` and the gtime epoch/gpst
conversions of the vendored rtklib subset (`lib/rtklib/rtkcmn.c:84-505`).
"""
from __future__ import annotations

import datetime as _dt

GPS_EPOCH = _dt.datetime(1980, 1, 6)

# (utc datetime when the offset became effective, GPS - UTC seconds) —
# newest first, the sdrcmn.c:775-811 table brought forward.
LEAP_TABLE = [
    (_dt.datetime(2017, 1, 1), 18),
    (_dt.datetime(2015, 7, 1), 17),
    (_dt.datetime(2012, 7, 1), 16),
    (_dt.datetime(2009, 1, 1), 15),
    (_dt.datetime(2006, 1, 1), 14),
    (_dt.datetime(1999, 1, 1), 13),
    (_dt.datetime(1997, 7, 1), 12),
    (_dt.datetime(1996, 1, 1), 11),
    (_dt.datetime(1994, 7, 1), 10),
    (_dt.datetime(1993, 7, 1), 9),
    (_dt.datetime(1992, 7, 1), 8),
    (_dt.datetime(1991, 1, 1), 7),
    (_dt.datetime(1990, 1, 1), 6),
    (_dt.datetime(1988, 1, 1), 5),
    (_dt.datetime(1985, 7, 1), 4),
    (_dt.datetime(1983, 7, 1), 3),
    (_dt.datetime(1982, 7, 1), 2),
    (_dt.datetime(1981, 7, 1), 1),
    (GPS_EPOCH, 0),
]


def calendar_to_week_tow(y: int, mo: int, d: int, h: int = 0, mi: int = 0,
                         s: float = 0.0) -> tuple[int, float]:
    """Calendar epoch (GPS timescale) -> (full GPS week, time of week)."""
    t = _dt.datetime(y, mo, d, h, mi) - GPS_EPOCH
    total = t.total_seconds() + s
    week = int(total // 604800)
    return week, total - week * 604800.0


def week_tow_to_calendar(week: int, tow_s: float) -> _dt.datetime:
    return GPS_EPOCH + _dt.timedelta(seconds=week * 604800.0 + tow_s)


def leap_seconds(utc: _dt.datetime) -> int:
    """GPS - UTC offset in effect at a UTC datetime."""
    for eff, off in LEAP_TABLE:
        if utc >= eff:
            return off
    return 0


def gpst_to_utc(week: int, tow_s: float) -> _dt.datetime:
    t = week_tow_to_calendar(week, tow_s)
    return t - _dt.timedelta(seconds=leap_seconds(t))


def utc_to_gpst(utc: _dt.datetime) -> tuple[int, float]:
    t = utc + _dt.timedelta(seconds=leap_seconds(utc))
    d = (t - GPS_EPOCH).total_seconds()
    week = int(d // 604800)
    return week, d - week * 604800.0


def adjust_week_rollover(week10: int, ref_full_week: int = 2400) -> int:
    """10-bit broadcast week -> full week nearest the reference epoch
    (adjgpsweek role, rtkcmn.c)."""
    w = week10 % 1024
    k = round((ref_full_week - w) / 1024.0)
    return w + int(k) * 1024
