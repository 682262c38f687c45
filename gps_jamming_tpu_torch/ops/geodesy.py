"""Geodetic conversions and topocentric geometry (counterpart of
gps_jamming_tpu.ops.geodesy).

`sdrpvt.c:416-438` (ecef2lla, iterative), `sdrpvt.c:845-967` (togeod /
topocent az-el), `add_jammer_and_mix.py:14-24` (lla2ecef),
`triangulateRSSI.py:42-52` (small-offset meters <-> degrees) and the
haversine distance of `helpers/analyze_position.py`.

Float32, as the JAX package computes them (plenty for the < 1 m
localization target; the receiver's PVT runs float64 NumPy on the host):
a tensor keeps its device and dtype, and a Python number becomes a
float32 tensor on the host.
"""
from __future__ import annotations

import torch

from ..utils import constants as C


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        x, dtype=torch.float32)


def lla_to_ecef(lat_deg, lon_deg, alt_m):
    """WGS-84 geodetic -> ECEF (add_jammer_and_mix.py:14-24)."""
    lat = torch.deg2rad(_t(lat_deg))
    lon = torch.deg2rad(_t(lon_deg))
    alt_m = _t(alt_m)
    sl = torch.sin(lat)
    n = C.WGS84_A / torch.sqrt(1.0 - C.WGS84_E_SQ * sl * sl)
    x = (n + alt_m) * torch.cos(lat) * torch.cos(lon)
    y = (n + alt_m) * torch.cos(lat) * torch.sin(lon)
    z = (n * (1.0 - C.WGS84_E_SQ) + alt_m) * sl
    return x, y, z


def ecef_to_lla(x, y, z, iterations: int = 10):
    """ECEF -> WGS-84 geodetic by a fixed number of fixed-point iterations
    (the reference's ecef2lla loops to convergence; 10 converge well below
    1 cm). Returns (lat_deg, lon_deg, height_m)."""
    x, y, z = _t(x), _t(y), _t(z)
    lon = torch.atan2(y, x)
    p = torch.sqrt(x * x + y * y)
    e2 = C.WGS84_E_SQ
    phi = torch.atan2(z, p * (1.0 - e2))
    h = torch.zeros_like(p)
    for _ in range(iterations):
        sp = torch.sin(phi)
        n = C.WGS84_A / torch.sqrt(1.0 - e2 * sp * sp)
        h = p / torch.cos(phi) - n
        phi = torch.atan2(z, p * (1.0 - e2 * (n / (n + h))))
    return torch.rad2deg(phi), torch.rad2deg(lon), h


def enu_basis(lat_deg, lon_deg):
    """Rows: east, north, up unit vectors at the given geodetic location."""
    lat = torch.deg2rad(_t(lat_deg))
    lon = torch.deg2rad(_t(lon_deg))
    sl, cl = torch.sin(lat), torch.cos(lat)
    so, co = torch.sin(lon), torch.cos(lon)
    e = torch.stack([-so, co, torch.zeros_like(so)], dim=-1)
    n = torch.stack([-sl * co, -sl * so, cl], dim=-1)
    u = torch.stack([cl * co, cl * so, sl], dim=-1)
    return e, n, u


def topocentric(obs_ecef, dx_ecef):
    """Azimuth/elevation/distance of dx (ECEF delta) seen from obs_ecef
    (sdrpvt.c:845-967). Returns (az_deg in [0, 360), el_deg, dist_m)."""
    obs_ecef, dx_ecef = _t(obs_ecef), _t(dx_ecef)
    lat, lon, _ = ecef_to_lla(obs_ecef[..., 0], obs_ecef[..., 1],
                              obs_ecef[..., 2])
    e, n, u = enu_basis(lat, lon)
    de = (dx_ecef * e).sum(dim=-1)
    dn = (dx_ecef * n).sum(dim=-1)
    du = (dx_ecef * u).sum(dim=-1)
    dist = torch.sqrt(de * de + dn * dn + du * du)
    horiz = torch.sqrt(de * de + dn * dn)
    az = torch.remainder(torch.rad2deg(torch.atan2(de, dn)), 360.0)
    el = torch.rad2deg(torch.atan2(du, horiz.clamp(min=1e-12)))
    return az, el, dist


def meters_to_degrees(dx_east_m, dy_north_m, reference_lat_deg):
    """Small-offset meters -> (dlat_deg, dlon_deg) (triangulateRSSI.py:42-52)."""
    dlat = _t(dy_north_m) / C.METERS_PER_DEGREE_LAT
    mlon = C.METERS_PER_DEGREE_LON * torch.cos(
        torch.deg2rad(_t(reference_lat_deg)))
    return dlat, _t(dx_east_m) / mlon


def degrees_to_meters(dlat_deg, dlon_deg, reference_lat_deg):
    """Inverse of meters_to_degrees."""
    dy = _t(dlat_deg) * C.METERS_PER_DEGREE_LAT
    dx = _t(dlon_deg) * C.METERS_PER_DEGREE_LON * torch.cos(
        torch.deg2rad(_t(reference_lat_deg)))
    return dx, dy


def haversine_m(lat1_deg, lon1_deg, lat2_deg, lon2_deg):
    """Great-circle distance in meters (helpers/analyze_position.py oracle)."""
    r = 6_371_000.0
    p1, p2 = torch.deg2rad(_t(lat1_deg)), torch.deg2rad(_t(lat2_deg))
    dp = p2 - p1
    # the longitude difference in the inputs' own precision (float64 for
    # Python numbers), as the JAX package takes it, before float32
    dl = torch.deg2rad(_t(lon2_deg - lon1_deg))
    a = torch.sin(dp / 2) ** 2 + torch.cos(p1) * torch.cos(p2) \
        * torch.sin(dl / 2) ** 2
    return 2 * r * torch.arcsin(torch.sqrt(a))
