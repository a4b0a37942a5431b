"""Atmospheric propagation-delay models (ionosphere + troposphere).

The reference has NO atmospheric model — its README attributes the rare
systematic position deviations >20 m to exactly this omission
(/root/reference/README.md:26).  This module closes that gap:

  * Klobuchar ionospheric group delay (IS-GPS-200 20.3.3.5.2.5), driven
    by the eight alpha/beta coefficients broadcast in subframe 4 page 18
    (decoded by models/navmsg.py — the reference stubs subframes 4/5
    out entirely, gpslib.py:373-377).
  * Saastamoinen-style tropospheric zenith delay under a standard
    atmosphere, mapped to the line of sight.

Both are pure vectorized float64 host math (the orbit/PVT dtype domain,
reference gpsglob.py:127-131): corrections are O(satellites) per epoch,
six orders of magnitude below the IQ stream, so they belong on the host
next to the pseudorange bookkeeping, not on the accelerator.

The same functions serve double duty as the signal simulator's truth
model (models/scenario.py injects these delays into the synthesized IQ)
and as the evaluator's correction (runtime/evaluator.py subtracts them
from measured pseudoranges) — sign conventions are therefore pinned by
the closed-loop tests, not by convention alone.
"""

from __future__ import annotations

import numpy as np

from gps_sdr.config import GPS_C

DAY_SEC = 86400.0
_NIGHT_DELAY = 5.0e-9        # s; Klobuchar nighttime floor


def klobuchar_delay(alpha, beta, lat_rad, lon_rad, el_rad, az_rad,
                    t_gps_sec):
    """Ionospheric group delay [s] on the GPS L1 line of sight.

    IS-GPS-200 20.3.3.5.2.5 ("Ionospheric Model"), computed in
    semicircles as specified.  Broadcasts over el/az/t arrays.

    alpha, beta : the four amplitude / period coefficients from
                  subframe 4 page 18 (seconds, seconds/semicircle^n).
    lat/lon     : receiver geodetic position [rad].
    el, az      : satellite elevation / azimuth [rad].
    t_gps_sec   : GPS time of week [s] (any epoch; used mod 86400).
    """
    a = np.asarray(alpha, np.float64)
    b = np.asarray(beta, np.float64)
    el_sc = np.asarray(el_rad, np.float64) / np.pi
    az = np.asarray(az_rad, np.float64)
    # earth-centered angle to the ionospheric pierce point [semicircles]
    psi = 0.0137 / (el_sc + 0.11) - 0.022
    phi_i = lat_rad / np.pi + psi * np.cos(az)
    phi_i = np.clip(phi_i, -0.416, 0.416)
    lam_i = lon_rad / np.pi + psi * np.sin(az) / np.cos(phi_i * np.pi)
    # geomagnetic latitude of the pierce point
    phi_m = phi_i + 0.064 * np.cos((lam_i - 1.617) * np.pi)
    # local time at the pierce point
    t = np.mod(4.32e4 * lam_i + np.asarray(t_gps_sec, np.float64),
               DAY_SEC)
    # obliquity (slant) factor
    f = 1.0 + 16.0 * (0.53 - el_sc) ** 3
    per = b[0] + phi_m * (b[1] + phi_m * (b[2] + phi_m * b[3]))
    per = np.maximum(per, 72000.0)
    amp = a[0] + phi_m * (a[1] + phi_m * (a[2] + phi_m * a[3]))
    amp = np.maximum(amp, 0.0)
    x = 2.0 * np.pi * (t - 50400.0) / per
    day = _NIGHT_DELAY + amp * (1.0 - x * x / 2.0 + x ** 4 / 24.0)
    return f * np.where(np.abs(x) < 1.57, day, _NIGHT_DELAY)


def tropo_delay(el_rad, height_m=0.0):
    """Tropospheric delay [s] on the line of sight.

    Saastamoinen zenith delays under the ISA standard atmosphere
    (pressure/temperature lapsed from sea level to the receiver height,
    50% relative humidity), mapped with the standard
    1.001/sqrt(0.002001 + sin^2 el) single mapping function — the
    few-centimeter class of model appropriate for a meter-level
    receiver.  Broadcasts over el arrays.
    """
    el = np.asarray(el_rad, np.float64)
    h = np.clip(np.asarray(height_m, np.float64), -500.0, 11000.0)
    # ISA: temperature and pressure at receiver height
    t0 = 288.15 - 6.5e-3 * h                       # K
    p0 = 1013.25 * (t0 / 288.15) ** 5.2568         # hPa
    # 50% relative humidity -> partial water-vapor pressure [hPa]
    e0 = 0.5 * 6.108 * np.exp(17.27 * (t0 - 273.15) / (t0 - 35.85))
    zen_dry = 0.002277 * p0                        # m
    zen_wet = 0.002277 * (1255.0 / t0 + 0.05) * e0  # m
    s = np.sin(np.maximum(el, np.deg2rad(3.0)))
    m = 1.001 / np.sqrt(0.002001 + s * s)
    return (zen_dry + zen_wet) * m / GPS_C


def azim_elev_batch(obs_ecef, sat_ecef):
    """(elev_rad[N], azim_rad[N]) of satellites [N, 3] from one ECEF
    observer — the vectorized companion of
    utils.geodesy.ecef_to_azim_elev (same ENU convention: azimuth from
    north through east)."""
    from gps_sdr.utils.geodesy import ecef_to_geo

    obs = np.asarray(obs_ecef, np.float64)
    sat = np.atleast_2d(np.asarray(sat_ecef, np.float64))
    lat, lon, _ = ecef_to_geo(obs)
    lat, lon = np.deg2rad(lat), np.deg2rad(lon)
    sl, cl = np.sin(lat), np.cos(lat)
    so, co = np.sin(lon), np.cos(lon)
    d = sat - obs[None, :]
    east = -so * d[:, 0] + co * d[:, 1]
    north = -sl * co * d[:, 0] - sl * so * d[:, 1] + cl * d[:, 2]
    up = cl * co * d[:, 0] + cl * so * d[:, 1] + sl * d[:, 2]
    elev = np.arcsin(up / np.linalg.norm(d, axis=1))
    return elev, np.arctan2(east, north)
