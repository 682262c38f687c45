"""Satellite position/clock from broadcast ephemeris (Kepler solver).

NumPy copy of `gps_jamming_tpu.models.receiver.ephemeris`, whose package
imports jax (the machine with the card has none). The two stay equal;
tests/test_torch_receiver_host.py holds them so.

Host-side float64 numpy, batched over satellites — re-design of `satPos`
(sdrpvt.c:440-537), which computes one satellite at a time in scalar C.
Orbital math needs double precision (ECEF ~2.6e7 m at mm residuals), so
like the reference this stays on the host; it is
tiny (a handful of flops per satellite per 200 ms PVT epoch) and vectorized
over the constellation. GLONASS pos/vel/acc extrapolation
(sdrpvt.c:539-575) is an RK4 integrator over the PZ-90 force model.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

from ...utils import constants as C
from .lnav import Ephemeris


class EphArrays(NamedTuple):
    """Struct-of-arrays ephemeris batch (all shape (n_sat,), float64)."""
    toe: np.ndarray
    toc: np.ndarray
    sqrt_a: np.ndarray
    e: np.ndarray
    m0: np.ndarray
    delta_n: np.ndarray
    omega0: np.ndarray
    omega_dot: np.ndarray
    omega: np.ndarray
    i0: np.ndarray
    idot: np.ndarray
    cuc: np.ndarray
    cus: np.ndarray
    crc: np.ndarray
    crs: np.ndarray
    cic: np.ndarray
    cis: np.ndarray
    af0: np.ndarray
    af1: np.ndarray
    af2: np.ndarray
    tgd: np.ndarray


def stack_ephemeris(ephs: Sequence[Ephemeris]) -> EphArrays:
    """Pack a list of decoded Ephemeris into batched float64 arrays."""
    def col(name):
        return np.array([getattr(e, name) for e in ephs], dtype=np.float64)
    return EphArrays(*[col(f) for f in EphArrays._fields])


def time_diff_wrap(t, t_ref):
    """tk = t - t_ref wrapped into [-302400, 302400) (half-week rule,
    sdrpvt.c:454-459)."""
    tk = np.asarray(t, np.float64) - np.asarray(t_ref, np.float64)
    tk = np.where(tk > C.GPS_HALF_WEEK_SECONDS, tk - C.GPS_WEEK_SECONDS, tk)
    tk = np.where(tk < -C.GPS_HALF_WEEK_SECONDS, tk + C.GPS_WEEK_SECONDS, tk)
    return tk


def kepler_anomaly(mk: np.ndarray, e: np.ndarray,
                   iters: int = 15) -> np.ndarray:
    """Solve Kepler's equation M = E - e sin E by fixed-point iteration
    (same scheme as sdrpvt.c:468-473)."""
    ek = np.array(mk, dtype=np.float64)
    for _ in range(iters):
        ek = mk + e * np.sin(ek)
    return ek


def sat_pos_clock(eph: EphArrays, t_sv) -> tuple[np.ndarray, np.ndarray]:
    """Batched satellite ECEF position + clock correction at transmit time.

    Args:
      eph: batched ephemeris arrays, shape (n_sat,).
      t_sv: (n_sat,) GPS time of week at transmission [s] (uncorrected).

    Returns (pos_ecef (n_sat, 3) [m], clk (n_sat,) [s]) — clock includes
    the af polynomial, relativistic correction, and TGD (sdrpvt.c usage in
    pvtProcessor, sdrpvt.c:95-109).
    """
    t_sv = np.asarray(t_sv, np.float64)
    dtc = time_diff_wrap(t_sv, eph.toc)
    clk = eph.af0 + eph.af1 * dtc + eph.af2 * dtc * dtc
    t = t_sv - clk
    tk = time_diff_wrap(t, eph.toe)

    a = eph.sqrt_a * eph.sqrt_a
    n0 = np.sqrt(C.GPS_MU / (a * a * a))
    n = n0 + eph.delta_n
    mk = eph.m0 + n * tk
    ek = kepler_anomaly(mk, eph.e)
    sin_ek = np.sin(ek)
    cos_ek = np.cos(ek)

    # relativistic clock correction (sdrpvt.c:478) and group delay
    rel = C.GPS_F_REL * eph.e * eph.sqrt_a * sin_ek
    clk = clk + rel - eph.tgd

    vk = np.arctan2(np.sqrt(1.0 - eph.e * eph.e) * sin_ek, cos_ek - eph.e)
    phik = vk + eph.omega
    s2p = np.sin(2.0 * phik)
    c2p = np.cos(2.0 * phik)
    uk = phik + eph.cus * s2p + eph.cuc * c2p
    rk = a * (1.0 - eph.e * cos_ek) + eph.crs * s2p + eph.crc * c2p
    ik = eph.i0 + eph.idot * tk + eph.cis * s2p + eph.cic * c2p

    xo = rk * np.cos(uk)
    yo = rk * np.sin(uk)
    omk = (eph.omega0 + (eph.omega_dot - C.OMEGA_E_DOT) * tk
           - C.OMEGA_E_DOT * eph.toe)
    so = np.sin(omk)
    co = np.cos(omk)
    ci = np.cos(ik)
    si = np.sin(ik)
    pos = np.stack([xo * co - yo * ci * so,
                    xo * so + yo * ci * co,
                    yo * si], axis=-1)
    return pos, clk


def sat_velocity(eph: EphArrays, t_sv, dt: float = 0.5) -> np.ndarray:
    """Satellite ECEF velocity by symmetric differencing (used for Doppler
    prediction; the reference does the same implicitly via obs interp)."""
    p1, _ = sat_pos_clock(eph, np.asarray(t_sv) - dt)
    p2, _ = sat_pos_clock(eph, np.asarray(t_sv) + dt)
    return (p2 - p1) / (2.0 * dt)


# ---------------------------------------------------------------------------
# GLONASS: broadcast pos/vel/acc state extrapolation (PZ-90), RK4 over the
# force model used by sdrpvt.c:539-575.
# ---------------------------------------------------------------------------

_GLO_MU = 398600.44e9
_GLO_J2 = 1.0826257e-3
_GLO_RE = 6378136.0
_GLO_OMG = 7.292115e-5


def _glo_deriv(state: np.ndarray, acc: np.ndarray) -> np.ndarray:
    """d/dt of (pos, vel) under central + J2 + earth-rotation forces."""
    x, y, z, vx, vy, vz = (state[..., i] for i in range(6))
    r2 = x * x + y * y + z * z
    r = np.sqrt(r2)
    r3 = r2 * r
    k1 = -_GLO_MU / r3
    c = 1.5 * _GLO_J2 * _GLO_MU * _GLO_RE * _GLO_RE / (r2 * r3)
    zz = z * z / r2
    ax = (k1 + c * (1.0 - 5.0 * zz)) * x + _GLO_OMG * _GLO_OMG * x \
        + 2.0 * _GLO_OMG * vy + acc[..., 0]
    ay = (k1 + c * (1.0 - 5.0 * zz)) * y + _GLO_OMG * _GLO_OMG * y \
        - 2.0 * _GLO_OMG * vx + acc[..., 1]
    az = (k1 + c * (3.0 - 5.0 * zz)) * z + acc[..., 2]
    return np.stack([vx, vy, vz, ax, ay, az], axis=-1)


def glonass_extrapolate(pos0, vel0, acc, dt, n_steps: int = 16) -> np.ndarray:
    """RK4-integrate GLONASS broadcast state forward by dt seconds."""
    state = np.concatenate([np.asarray(pos0, np.float64),
                            np.asarray(vel0, np.float64)], axis=-1)
    acc = np.asarray(acc, np.float64)
    h = np.asarray(dt, np.float64) / n_steps
    h = h[..., None] if np.ndim(h) else h
    for _ in range(n_steps):
        k1 = _glo_deriv(state, acc)
        k2 = _glo_deriv(state + 0.5 * h * k1, acc)
        k3 = _glo_deriv(state + 0.5 * h * k2, acc)
        k4 = _glo_deriv(state + h * k3, acc)
        state = state + h / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
    return state[..., :3]
