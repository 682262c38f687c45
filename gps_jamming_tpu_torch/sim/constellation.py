"""Ephemeris-consistent GNSS capture simulator (geometry-true fixtures).

NumPy copy of `gps_jamming_tpu.sim.constellation` (`SatTruth`,
`geometric_range`, `render_signal`, `render_satellite`,
`simulate_constellation`, `simulate_galileo_constellation`,
`glo_geometric_range`, `simulate_glonass_constellation`, and the receiver
tests' 24-satellite GPS shell as `gps_shell`), which imports the
jax-importing receiver package. It renders baseband where each
satellite's code phase, carrier phase, Doppler and nav symbols agree with
the geometry, so acquisition, tracking, decode and PVT can be checked
against ground truth on a machine without JAX.
tests/test_torch_receiver_host.py and tests/test_torch_systems.py hold it
equal to the JAX package's.

Signal model, per satellite:
  t_tx(t_rx) = t_gps(t_rx) - rho(t_rx)/c          (transit delay)
  chip(t)    = 1.023e6 * t_tx  (mod 1023)         (code phase)
  bit(t)     = LNAV bit at 50 bps of t_tx
  carrier    = exp(-j*2*pi*fL1*rho(t_rx)/c)       (geometric phase -> Doppler)
rho(t) is evaluated on a coarse grid from the Kepler solver and
quadratically interpolated per sample. Host float64 numpy (fixture
generation, not a hot path).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..utils import constants as C
from ..models.receiver import ephemeris as eph_mod
from ..models.receiver import galileo as gal
from ..models.receiver import glonass as glo
from ..models.receiver import lnav, pvt
from ..ops import codes as codes_ops


@dataclasses.dataclass(frozen=True)
class SatTruth:
    """Ground truth per satellite at capture start (for assertions)."""
    prn: int
    range_m: float
    doppler_hz: float
    code_phase_chips: float    # signal code phase at receiver sample 0
    pseudorange_m: float


def geometric_range(eph: eph_mod.EphArrays, t_gps, rx_ecef: np.ndarray,
                    light_time_iters: int = 2) -> np.ndarray:
    """Range at reception time t_gps: iterate transmit time for light time,
    with Sagnac handled by evaluating the satellite at t-tau and rotating
    (the same physics blsFilter corrects for, sdrpvt.c:240-245)."""
    t_gps = np.asarray(t_gps, np.float64)
    tau = np.full_like(t_gps, 0.075)
    for _ in range(light_time_iters + 1):
        pos, _ = eph_mod.sat_pos_clock(eph, t_gps - tau)
        pos = pvt.sagnac_rotate(pos, tau)
        rho = np.linalg.norm(pos - rx_ecef, axis=-1)
        tau = rho / C.SPEED_OF_LIGHT
    return rho


def render_signal(rho_coeffs: np.ndarray, clk0_s: float,
                 code: np.ndarray, chip_rate: float,
                 symbols_pm1: np.ndarray, symbol_rate: float,
                 symbols_t0: float,
                 t0: float, n_samples: int, fs: float,
                 carrier_hz: float, baseband_offset_hz: float = 0.0,
                 amplitude: float = 1.0,
                 out: np.ndarray | None = None,
                 chunk: int = 1 << 21) -> np.ndarray:
    """Render one ranging signal's complex baseband into `out` (complex128).

    Generic over constellation: `code` +/-1 chips at `chip_rate`,
    `symbols_pm1` +/-1 data symbols at `symbol_rate` anchored at
    transmit time `symbols_t0`, carrier Doppler from the quadratic range
    fit `rho_coeffs` (meters vs seconds-since-t0), and a static
    `baseband_offset_hz` for FDMA carriers away from the front-end
    centre. Renders in chunks to bound the float64 temporaries (the role
    of the reference's 1 MiB mixer chunks, spoofer_mixer.py:11).
    """
    if out is None:
        out = np.zeros(n_samples, dtype=np.complex128)
    code = np.asarray(code, np.float64)
    code_len = code.size
    symbols_pm1 = np.asarray(symbols_pm1, np.float64)

    phase0 = None
    for s0 in range(0, n_samples, chunk):
        s1 = min(s0 + chunk, n_samples)
        t = np.arange(s0, s1, dtype=np.float64) / fs
        rho = np.polyval(rho_coeffs, t)
        tau = rho / C.SPEED_OF_LIGHT
        t_tx = t0 + t - tau + clk0_s

        chip_idx = (np.floor(chip_rate * t_tx).astype(np.int64) % code_len)
        chip_vals = code[chip_idx]
        sym_idx = np.floor((t_tx - symbols_t0) * symbol_rate) \
            .astype(np.int64)
        sym_vals = symbols_pm1[np.clip(sym_idx, 0, symbols_pm1.size - 1)]

        phase = (-2.0 * np.pi * carrier_hz * tau
                 + 2.0 * np.pi * baseband_offset_hz * t)
        if phase0 is None:
            phase0 = phase[0]          # arbitrary initial phase -> 0
        out[s0:s1] += amplitude * chip_vals * sym_vals * np.exp(
            1j * (phase - phase0))
    return out


def _traj_rx(rows: np.ndarray, t_rel) -> np.ndarray:
    """Interpolate user-motion rows (t, x, y, z) — the gps-sdr-sim -u CSV
    contract of trajectory.linear_trajectory — at `t_rel` seconds from the
    first row. Returns (len(t_rel), 3) ECEF."""
    rows = np.asarray(rows, np.float64)
    t = np.atleast_1d(np.asarray(t_rel, np.float64))
    return np.stack([np.interp(t, rows[:, 0], rows[:, 1 + k])
                     for k in range(3)], axis=-1)


def _range_fit(eph1: eph_mod.EphArrays, t0: float, dur: float,
               rx_ecef: np.ndarray, grid_step_s: float = 1.0,
               rx_rows: np.ndarray | None = None) -> np.ndarray:
    """Polynomial fit of geometric range over the capture. Static receiver:
    quadratic (range accel < 1 m/s^2 keeps fit error < 1 mm over tens of
    seconds). Moving receiver (rx_rows user-motion): quartic — for vehicle
    speeds the extra curvature stays well inside a degree-4 fit."""
    n_grid = max(int(np.ceil(dur / grid_step_s)) + 2, 5)
    tg = np.linspace(0.0, dur, n_grid)
    rx = _traj_rx(rx_rows, tg) if rx_rows is not None else rx_ecef
    rho_g = geometric_range(eph1, t0 + tg, rx)
    deg = 2 if rx_rows is None else min(4, n_grid - 1)
    return np.polyfit(tg, rho_g, deg)


def render_satellite(eph1: eph_mod.EphArrays, prn: int, rx_ecef: np.ndarray,
                     t0_gps: float, n_samples: int, fs: float,
                     bits: np.ndarray, bits_t0: float,
                     amplitude: float = 1.0,
                     grid_step_s: float = 1.0,
                     out: np.ndarray | None = None,
                     chunk: int = 1 << 21,
                     rx_rows: np.ndarray | None = None) -> np.ndarray:
    """Render one GPS satellite's complex baseband into `out`.

    eph1: single-satellite EphArrays (shape-(1,) columns).
    t0_gps: GPS ToW at receiver sample 0.
    bits / bits_t0: LNAV +/-1-valued bits of the data message and the GPS
    time of the first bit's leading edge.
    rx_rows: optional (t, x, y, z) user motion; overrides the static
    rx_ecef geometry (gps-sdr-sim -u role).
    """
    coeffs = _range_fit(eph1, t0_gps, n_samples / fs, rx_ecef, grid_step_s,
                        rx_rows=rx_rows)
    _, clk = eph_mod.sat_pos_clock(eph1, np.array([t0_gps]))
    return render_signal(
        coeffs, float(clk[0]), codes_ops.gps_ca_code(prn),
        C.GPS_CA_CHIP_RATE_HZ, bits, 50.0, bits_t0, t0_gps, n_samples, fs,
        C.GPS_L1_FREQ_HZ, 0.0, amplitude, out=out, chunk=chunk)


def gps_shell(toe: float, n: int = 24) -> list[lnav.Ephemeris]:
    """An n-satellite GPS shell at a common Toe (the JAX package's
    closed-loop receiver tests' `_shell`): spread mean anomalies, six
    planes, clock offsets of (k - 12) * 2 us; `simulate_constellation`
    keeps the satellites above 10 degrees."""
    return [lnav.Ephemeris(
        prn=k + 1, week=2400, toc=toe, af0=(k - 12) * 2e-6,
        af1=0.0, af2=0.0, tgd=0.0, iodc=100 + k, ura=1, health=0,
        iode=100 + k, toe=toe, sqrt_a=np.sqrt(26_560_000.0),
        e=0.008, m0=2.0 * np.pi * k / n,
        delta_n=4.5e-9, omega0=2.0 * np.pi * (k % 6) / 6.0,
        omega_dot=-8.0e-9, omega=0.25 * k, i0=0.958, idot=-3e-10,
        cuc=0.0, cus=0.0, crc=0.0, crs=0.0, cic=0.0, cis=0.0,
        have_subframes=(1, 2, 3)) for k in range(n)]


def galileo_shell(toe: float, n: int = 24) -> list[lnav.Ephemeris]:
    """An n-satellite Galileo shell at a common Toe (the JAX package's
    closed-loop E1B tests' `_gal_shell`; E1 shares the GPS orbit math):
    a = 29 600 km, spread mean anomalies, six planes, clock offsets of
    (k - 12) * 2 us, GST week 1340."""
    return [lnav.Ephemeris(
        prn=k + 1, week=1340, toc=toe, af0=(k - 12) * 2e-6,
        af1=0.0, af2=0.0, tgd=0.0, iodc=100 + k, ura=1, health=0,
        iode=100 + k, toe=toe, sqrt_a=np.sqrt(29_600_000.0),
        e=0.0003, m0=2.0 * np.pi * k / n,
        delta_n=3e-9, omega0=2.0 * np.pi * (k % 6) / 6.0,
        omega_dot=-5.6e-9, omega=0.25 * k, i0=0.975, idot=-2e-10,
        cuc=0.0, cus=0.0, crc=0.0, crs=0.0, cic=0.0, cis=0.0,
        have_subframes=(1, 2, 3, 4, 5)) for k in range(n)]


def glonass_shell(rx_lla: tuple[float, float, float],
                  tb: float) -> list["glo.GloEphemeris"]:
    """Five GLONASS satellites on FDMA channels -2..2 (the JAX package's
    closed-loop L1OF tests' `_glo_shell`): placed at spread azimuths and
    elevations from the receiver at the orbit radius, with circular-speed
    tangential velocities and clock offsets of (i - 2) * 4 us. The
    simulator and the receiver extrapolate the same broadcast state with
    the same RK4 force model, so the geometry closes."""
    r_orb = 25_508_000.0
    rx = pvt.lla_to_ecef(*rx_lla)
    lat, lon = np.deg2rad(rx_lla[0]), np.deg2rad(rx_lla[1])
    e_hat = np.array([-np.sin(lon), np.cos(lon), 0.0])
    n_hat = np.array([-np.sin(lat) * np.cos(lon),
                      -np.sin(lat) * np.sin(lon), np.cos(lat)])
    u_hat = np.array([np.cos(lat) * np.cos(lon),
                      np.cos(lat) * np.sin(lon), np.sin(lat)])
    sats = []
    geom = [(0.0, 65.0), (85.0, 40.0), (170.0, 55.0), (255.0, 35.0),
            (320.0, 70.0)]
    for i, (az_d, el_d) in enumerate(geom):
        az, el = np.deg2rad(az_d), np.deg2rad(el_d)
        ray = (np.sin(az) * np.cos(el) * e_hat
               + np.cos(az) * np.cos(el) * n_hat + np.sin(el) * u_hat)
        # |rx + d*ray| = r_orb
        b = 2.0 * rx.dot(ray)
        c0 = rx.dot(rx) - r_orb ** 2
        d = (-b + np.sqrt(b * b - 4 * c0)) / 2.0
        pos = rx + d * ray
        v_circ = np.sqrt(3.986e14 / r_orb)
        t1 = np.cross(pos, [0.0, 0.0, 1.0])
        t1 /= np.linalg.norm(t1)
        t2 = np.cross(pos / np.linalg.norm(pos), t1)
        ang = 0.7 * i
        vel = v_circ * (np.cos(ang) * t1 + np.sin(ang) * t2)
        sats.append(glo.GloEphemeris(
            freq_ch=i - 2, tb_s=tb, tk_s=0.0,
            pos_m=tuple(pos), vel_mps=tuple(vel),
            acc_mps2=(0.0, 0.0, 0.0),
            tau_s=(i - 2) * 4e-6, gamma=0.0))
    return sats


def simulate_constellation(ephs: Sequence[lnav.Ephemeris],
                           rx_lla: tuple[float, float, float],
                           tow0: float, n_samples: int, fs: float,
                           amplitudes: Sequence[float] | None = None,
                           noise_std: float = 0.0, seed: int = 0,
                           min_elevation_deg: float = 10.0,
                           rx_traj: np.ndarray | None = None):
    """Render a multi-satellite capture + ground truth.

    Args:
      ephs: decoded-style Ephemeris records (one per satellite).
      rx_lla: receiver (lat_deg, lon_deg, height_m).
      tow0: GPS ToW at receiver sample 0; nav bits start at the previous
        subframe boundary so decoders see whole subframes.
      rx_traj: optional (t, x, y, z) user-motion rows
        (trajectory.linear_trajectory) — a MOVING receiver, the
        gps-sdr-sim -u mode; overrides rx_lla for the signal geometry
        (visibility/truths use the trajectory's t=0 point).
      Returns (iq complex128 (n_samples,), truths: list[SatTruth],
      rx_ecef (3,)).
    """
    rx_ecef = pvt.lla_to_ecef(*rx_lla)
    if rx_traj is not None:
        rx_traj = np.asarray(rx_traj, np.float64)
        rx_ecef = _traj_rx(rx_traj, 0.0)[0]
    batch = eph_mod.stack_ephemeris(ephs)
    out = np.zeros(n_samples, dtype=np.complex128)
    truths = []
    amplitudes = amplitudes or [1.0] * len(ephs)

    # visibility filter
    pos0, _ = eph_mod.sat_pos_clock(batch, np.full(len(ephs), tow0))
    e_, n_, u_ = pvt.topocentric(rx_ecef, pos0 - rx_ecef)
    el = np.rad2deg(np.arctan2(u_, np.hypot(e_, n_)))

    sf0 = np.floor(tow0 / 6.0) * 6.0 - 6.0       # one subframe of lead-in
    dur = n_samples / fs
    n_sf = int(np.ceil((dur + tow0 - sf0) / 6.0)) + 2

    for k, eph in enumerate(ephs):
        if el[k] < min_elevation_deg:
            continue
        one = eph_mod.EphArrays(*[c[k:k + 1] for c in batch])
        bits01 = lnav.encode_frames(eph, start_tow_s=sf0, n_subframes=n_sf)
        bits = bits01.astype(np.float64) * 2.0 - 1.0
        render_satellite(one, eph.prn, rx_ecef, tow0, n_samples, fs,
                         bits, sf0, amplitudes[k], out=out,
                         rx_rows=rx_traj)

        # moving receiver: short dt so the truth Doppler is the
        # INSTANTANEOUS range rate at t0 (the trajectory clamps at the
        # capture end, so a long quotient would under-read the motion)
        dt = 0.01 if rx_traj is not None else 0.5
        rx_dt = (_traj_rx(rx_traj, dt)[0] if rx_traj is not None
                 else rx_ecef)
        rho0 = geometric_range(one, np.array([tow0]), rx_ecef)[0]
        rho1 = geometric_range(one, np.array([tow0 + dt]), rx_dt)[0]
        doppler = -(rho1 - rho0) / dt / C.SPEED_OF_LIGHT * C.GPS_L1_FREQ_HZ
        _, clk = eph_mod.sat_pos_clock(one, np.array([tow0]))
        t_tx0 = tow0 - rho0 / C.SPEED_OF_LIGHT + clk[0]
        cp = (C.GPS_CA_CHIP_RATE_HZ * t_tx0) % C.GPS_CA_CODE_LEN
        truths.append(SatTruth(
            prn=eph.prn, range_m=float(rho0), doppler_hz=float(doppler),
            code_phase_chips=float(cp),
            pseudorange_m=float(rho0 - C.SPEED_OF_LIGHT * clk[0])))

    if noise_std > 0.0:
        rng = np.random.default_rng(seed)
        out = out + (rng.normal(0.0, noise_std, n_samples)
                     + 1j * rng.normal(0.0, noise_std, n_samples))
    return out, truths, rx_ecef


# ---------------------------------------------------------------------------
# Galileo E1B constellation
# ---------------------------------------------------------------------------

def simulate_galileo_constellation(ephs: Sequence[lnav.Ephemeris],
                                   rx_lla: tuple[float, float, float],
                                   tow0: float, n_samples: int, fs: float,
                                   amplitudes: Sequence[float] | None = None,
                                   noise_std: float = 0.0, seed: int = 0,
                                   min_elevation_deg: float = 10.0):
    """Geometry-true E1B capture: BOC(1,1) codes + live I/NAV pages.

    Same Keplerian geometry as GPS (E1 shares the L1 carrier); the data
    layer is the 250 sps I/NAV stream of galileo.encode_inav_stream with
    word-5 GST anchors. Use fs >= 4.096 MS/s: nearest-neighbor BOC
    synthesis at 2.048 MS/s aliases the doubled-subcarrier line into the
    Doppler band (see ops.codes.resample_code_bandlimited).
    """
    rx_ecef = pvt.lla_to_ecef(*rx_lla)
    batch = eph_mod.stack_ephemeris(ephs)
    out = np.zeros(n_samples, dtype=np.complex128)
    truths = []
    amplitudes = amplitudes or [1.0] * len(ephs)

    pos0, _ = eph_mod.sat_pos_clock(batch, np.full(len(ephs), tow0))
    e_, n_, u_ = pvt.topocentric(rx_ecef, pos0 - rx_ecef)
    el = np.rad2deg(np.arctan2(u_, np.hypot(e_, n_)))

    dur = n_samples / fs
    page0 = np.floor(tow0 / 2.0) * 2.0 - 2.0        # one page of lead-in
    n_pairs = int(np.ceil((dur + tow0 - page0) / 2.0)) + 2

    for k, eph in enumerate(ephs):
        if el[k] < min_elevation_deg:
            continue
        one = eph_mod.EphArrays(*[c[k:k + 1] for c in batch])
        sym01 = gal.encode_inav_stream(eph, page0, n_pairs)
        sym = 1.0 - 2.0 * sym01.astype(np.float64)
        coeffs = _range_fit(one, tow0, dur, rx_ecef)
        _, clk = eph_mod.sat_pos_clock(one, np.array([tow0]))
        render_signal(coeffs, float(clk[0]), gal.e1b_boc_code(eph.prn),
                      gal.BOC_RATE, sym, gal.SYMBOL_RATE_SPS, page0,
                      tow0, n_samples, fs, C.GPS_L1_FREQ_HZ, 0.0,
                      amplitudes[k], out=out)

        rho0 = geometric_range(one, np.array([tow0]), rx_ecef)[0]
        rho1 = geometric_range(one, np.array([tow0 + 0.5]), rx_ecef)[0]
        doppler = -(rho1 - rho0) / 0.5 / C.SPEED_OF_LIGHT \
            * C.GPS_L1_FREQ_HZ
        t_tx0 = tow0 - rho0 / C.SPEED_OF_LIGHT + clk[0]
        cp = (gal.BOC_RATE * t_tx0) % gal.BOC_LEN
        truths.append(SatTruth(
            prn=eph.prn, range_m=float(rho0), doppler_hz=float(doppler),
            code_phase_chips=float(cp),
            pseudorange_m=float(rho0 - C.SPEED_OF_LIGHT * clk[0])))

    if noise_std > 0.0:
        rng = np.random.default_rng(seed)
        out = out + (rng.normal(0.0, noise_std, n_samples)
                     + 1j * rng.normal(0.0, noise_std, n_samples))
    return out, truths, rx_ecef


# ---------------------------------------------------------------------------
# GLONASS L1OF constellation
# ---------------------------------------------------------------------------

def glo_geometric_range(geph, t, rx_ecef: np.ndarray,
                        light_time_iters: int = 2) -> np.ndarray:
    """GLONASS range at reception time t: RK4 state extrapolation from tb
    + light-time iteration + Sagnac rotation."""
    t = np.asarray(t, np.float64)
    tau = np.full_like(t, 0.085)
    pos0 = np.asarray(geph.pos_m, np.float64)
    vel0 = np.asarray(geph.vel_mps, np.float64)
    acc = np.asarray(geph.acc_mps2, np.float64)
    for _ in range(light_time_iters + 1):
        dt = t - tau - geph.tb_s
        pos = np.stack([eph_mod.glonass_extrapolate(pos0, vel0, acc,
                                                    float(d)) for d in dt])
        pos = pvt.sagnac_rotate(pos, tau)
        rho = np.linalg.norm(pos - rx_ecef, axis=-1)
        tau = rho / C.SPEED_OF_LIGHT
    return rho


def simulate_glonass_constellation(gephs: Sequence,
                                   rx_lla: tuple[float, float, float],
                                   t0: float, n_samples: int, fs: float,
                                   center_freq_hz: float | None = None,
                                   amplitudes: Sequence[float] | None = None,
                                   noise_std: float = 0.0, seed: int = 0,
                                   min_elevation_deg: float = 10.0):
    """Geometry-true L1OF capture: FDMA carriers + live GNAV strings.

    gephs: glonass.GloEphemeris records (freq_ch + pos/vel/acc at tb + tau/
    gamma); satellite motion is the same RK4 force model the receiver's
    satPos extrapolation uses, so the loop closes exactly. The reference
    has no GLONASS simulator at all (gps-sdr-sim is GPS-only).
    """
    center_freq_hz = center_freq_hz or C.GLO_G1_BASE_FREQ_HZ
    rx_ecef = pvt.lla_to_ecef(*rx_lla)
    out = np.zeros(n_samples, dtype=np.complex128)
    truths = []
    amplitudes = amplitudes or [1.0] * len(gephs)

    dur = n_samples / fs
    cyc0 = np.floor(t0 / 8.0) * 8.0 - 8.0
    n_cycles = int(np.ceil((dur + t0 - cyc0) / 8.0)) + 2

    for k, g in enumerate(gephs):
        pos0 = np.stack([eph_mod.glonass_extrapolate(
            np.asarray(g.pos_m, np.float64),
            np.asarray(g.vel_mps, np.float64),
            np.asarray(g.acc_mps2, np.float64), float(t0 - g.tb_s))])
        e_, n_, u_ = pvt.topocentric(rx_ecef, pos0[0] - rx_ecef)
        el = np.rad2deg(np.arctan2(u_, np.hypot(e_, n_)))
        if el < min_elevation_deg:
            continue
        sym01 = glo.encode_gnav_stream(g, cyc0, n_cycles)
        sym = 1.0 - 2.0 * sym01.astype(np.float64)
        carrier = codes_ops.glonass_carrier_hz(g.freq_ch)
        dur_grid = np.linspace(0.0, dur, max(int(np.ceil(dur)) + 2, 5))
        rho_g = glo_geometric_range(g, t0 + dur_grid, rx_ecef)
        coeffs = np.polyfit(dur_grid, rho_g, 2)
        clk0 = -g.tau_s + g.gamma * (t0 - g.tb_s)
        render_signal(coeffs, clk0, codes_ops.glonass_code(), C.GLO_CHIP_RATE_HZ,
                      sym, glo.SYMBOL_RATE_SPS, cyc0, t0, n_samples, fs,
                      carrier, carrier - center_freq_hz, amplitudes[k],
                      out=out)

        rho0 = float(rho_g[0])
        rho1 = glo_geometric_range(g, np.array([t0 + 0.5]), rx_ecef)[0]
        doppler = -(rho1 - rho0) / 0.5 / C.SPEED_OF_LIGHT * carrier
        t_tx0 = t0 - rho0 / C.SPEED_OF_LIGHT + clk0
        cp = (C.GLO_CHIP_RATE_HZ * t_tx0) % C.GLO_CODE_LEN
        truths.append(SatTruth(
            prn=g.freq_ch, range_m=rho0, doppler_hz=float(doppler),
            code_phase_chips=float(cp),
            pseudorange_m=float(rho0 - C.SPEED_OF_LIGHT * clk0)))

    if noise_std > 0.0:
        rng = np.random.default_rng(seed)
        out = out + (rng.normal(0.0, noise_std, n_samples)
                     + 1j * rng.normal(0.0, noise_std, n_samples))
    return out, truths, rx_ecef
