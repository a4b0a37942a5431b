"""Satellite orbit propagation per the GPS interface specification.

Functional, vectorized float64 replacement for the reference's SatPos
class (src/gpslib.py:427-642): given broadcast ephemeris parameters and
a transmission time, computes the satellite's ECEF position and the SV
clock correction, including the 2-pass relativistic correction.

All functions broadcast over leading axes, so one call evaluates every
epoch of a second (the reference called ecefCoord once per code phase,
gpslib.py:1011).  Float64 on the host — the reference deliberately keeps
orbit/PVT math in 64-bit while the DSP runs 32-bit (gpsglob.py:127-131);
these run at ~tens of evaluations per second, six orders of magnitude
below the IQ stream, so they are not device-path material.
"""

from __future__ import annotations

import numpy as np

from gps_sdr.config import OMEGA_EARTH, ROLLOVER, WEEK_IN_SEC

MU_EARTH = 3.986005e14          # m^3/s^2, WGS84 gravitational parameter
F_REL = -4.442807633e-10        # s/sqrt(m), relativistic clock constant


def cross_time(t):
    """Wrap a GPS time difference into +-half a week (week crossovers;
    reference CrossTime, gpslib.py:465-471)."""
    t = np.asarray(t, dtype=np.float64)
    half = WEEK_IN_SEC / 2
    return (t + half) % WEEK_IN_SEC - half


def tsv_of_tow(tow):
    """Nominal transmit time of the subframe whose HOW holds `tow`:
    the preamble leaves the SV at (tow-1)*6 s of week (gpslib.py:475-476)."""
    return (np.asarray(tow, dtype=np.float64) - 1.0) * 6.0


def sv_clock_correction(t_sv, eph, dtr=0.0):
    """SV clock offset dtsv = af0 + af1*dt + af2*dt^2 + dtr - Tgd
    (gpslib.py:478-481)."""
    dt = cross_time(t_sv - eph["Toc"])
    return (eph["af0"] + eph["af1"] * dt + eph["af2"] * dt * dt
            + dtr - eph["Tgd"])


def kepler_E(M, e, n_iter: int = 10):
    """Eccentric anomaly by Newton iteration on E - e sin E = M.

    Fixed iteration count (vectorized) instead of the reference's
    tolerance loop (gpslib.py:504-512); 10 Newton steps converge far
    below 1e-12 for GPS eccentricities (e < 0.03)."""
    E = np.asarray(M, dtype=np.float64).copy()
    for _ in range(n_iter):
        E = E - (E - e * np.sin(E) - M) / (1.0 - e * np.cos(E))
    return E


def ecef_coord(tow, eph, dt_from_tow=0.0, rel_corr: bool = True):
    """Satellite ECEF position and clock correction at transmit time.

    tow: time-of-week count of the reference subframe; dt_from_tow:
    seconds past that subframe's start (broadcasts).  Returns
    (x, y, z, dtsv) exactly as the reference's SatPos.ecefCoord
    (gpslib.py:589-642) including the two-pass relativistic correction.
    """
    t_sv = tsv_of_tow(tow) + np.asarray(dt_from_tow, dtype=np.float64)
    e = eph["e"]
    sqrt_a = eph["sqrtA"]
    dtr = 0.0
    for it in range(2 if rel_corr else 1):
        dtsv = sv_clock_correction(t_sv, eph, dtr=dtr)
        gps_t = t_sv - dtsv
        tk = cross_time(gps_t - eph["Toe"])
        n0 = np.sqrt(MU_EARTH) / sqrt_a ** 3
        Mk = eph["M0"] + (n0 + eph["deltaN"]) * tk
        Ek = kepler_E(Mk, e)
        if rel_corr and it == 0:
            dtr = F_REL * e * sqrt_a * np.sin(Ek)

    nu_k = np.arctan2(np.sqrt(1.0 - e * e) * np.sin(Ek), np.cos(Ek) - e)
    phi_k = nu_k + eph["omegaSmall"]
    s2p, c2p = np.sin(2.0 * phi_k), np.cos(2.0 * phi_k)
    du = eph["Cus"] * s2p + eph["Cuc"] * c2p
    dr = eph["Crc"] * c2p + eph["Crs"] * s2p
    di = eph["Cic"] * c2p + eph["Cis"] * s2p
    uk = phi_k + du
    rk = sqrt_a * sqrt_a * (1.0 - e * np.cos(Ek)) + dr
    ik = eph["i0"] + di + eph["IDOT"] * tk
    x_op = rk * np.cos(uk)
    y_op = rk * np.sin(uk)
    omega_k = (eph["omegaBig"] + (eph["omegaDot"] - OMEGA_EARTH) * tk
               - OMEGA_EARTH * eph["Toe"])
    so, co = np.sin(omega_k), np.cos(omega_k)
    ci, si = np.cos(ik), np.sin(ik)
    x = x_op * co - y_op * ci * so
    y = x_op * so + y_op * ci * co
    z = y_op * si
    return x, y, z, dtsv


def sat_velocity(tow, eph, dt_from_tow=0.0, h: float = 0.05):
    """Numerical ECEF velocity (central difference) — used by the signal
    simulator for Doppler ground truth; the reference has no equivalent."""
    xa, ya, za, _ = ecef_coord(tow, eph, np.asarray(dt_from_tow) - h)
    xb, yb, zb, _ = ecef_coord(tow, eph, np.asarray(dt_from_tow) + h)
    return ((xb - xa) / (2 * h), (yb - ya) / (2 * h), (zb - za) / (2 * h))


def gps_abs_time(tow, eph):
    """Seconds since the GPS epoch (1980-01-06) of the subframe start,
    clock-corrected (gpsTime, gpslib.py:580-586)."""
    t_sv = tsv_of_tow(tow)
    dtsv = sv_clock_correction(t_sv, eph)
    return ((eph["weekNum"] + ROLLOVER * 1024) * WEEK_IN_SEC
            + t_sv - dtsv)
