"""The port's RINEX 2 nav reader/writer (utils/rinex.py) and GPS time:
the JAX package's tests/test_rinex.py cases against the port's copies,
and files written by each package read equal by the other."""
import numpy as np

from gps_jamming_tpu.models.receiver import lnav as jlnav
from gps_jamming_tpu.utils import rinex as jrinex
from gps_jamming_tpu_torch.models.receiver import lnav
from gps_jamming_tpu_torch.utils import gpstime, rinex

EPH = dict(
    prn=7, week=2387, toc=432000.0, toe=432000.0, iode=91, iodc=91,
    af0=-5.44e-5, af1=8.75e-12, af2=0.0, tgd=-1.77e-8, ura=1, health=0,
    sqrt_a=5153.65, e=0.0166, m0=0.7097, delta_n=4.73e-9,
    omega0=-0.678, omega_dot=-8.66e-9, omega=-0.921, i0=0.9646,
    idot=-4.0e-10, cuc=-4.28e-6, cus=1.92e-6, crc=346.3, crs=-71.5,
    cic=1.19e-7, cis=-2.46e-7, have_subframes=(1, 2, 3))
FLOATS = ("toc", "toe", "af0", "af1", "sqrt_a", "e", "m0", "delta_n",
          "omega0", "omega_dot", "omega", "i0", "idot", "cuc", "cus",
          "crc", "crs", "cic", "cis", "tgd")
INTS = ("prn", "week", "iode", "iodc", "ura", "health")


def test_gps_time_roundtrip():
    week, tow = gpstime.calendar_to_week_tow(2025, 10, 10, 0, 0, 0.0)
    assert week == 2387 and tow == 432000.0      # known epoch of brdc2830
    t = gpstime.week_tow_to_calendar(week, tow)
    assert (t.year, t.month, t.day) == (2025, 10, 10)
    assert gpstime.leap_seconds(t) == 18
    assert gpstime.adjust_week_rollover(2387 % 1024, 2400) == 2387


def test_write_read_roundtrip(tmp_path):
    eph = lnav.Ephemeris(**EPH)
    path = str(tmp_path / "t.25n")
    rinex.write_nav(path, [eph])
    back = rinex.read_nav(path)
    assert len(back) == 1
    b = back[0]
    assert isinstance(b, lnav.Ephemeris)
    for f in INTS:
        assert getattr(b, f) == getattr(eph, f), f
    for f in FLOATS:
        assert np.isclose(getattr(b, f), getattr(eph, f),
                          rtol=1e-11, atol=1e-30), f


def test_files_equal_the_jax_packages(tmp_path):
    second = dict(EPH, prn=12, toc=439200.0, toe=439200.0, m0=-2.1,
                  af0=3.1e-6, week=2388)
    pt, pj = str(tmp_path / "t.25n"), str(tmp_path / "j.25n")
    rinex.write_nav(pt, [lnav.Ephemeris(**EPH), lnav.Ephemeris(**second)])
    jrinex.write_nav(pj, [jlnav.Ephemeris(**EPH), jlnav.Ephemeris(**second)])
    with open(pt) as a, open(pj) as b:
        assert a.read() == b.read()
    got, want = rinex.read_nav(pj), jrinex.read_nav(pt)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for f in INTS + FLOATS:
            assert getattr(g, f) == getattr(w, f), f

