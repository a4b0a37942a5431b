"""Kepler orbit propagation unit tests against IS-GPS-200 relations.

The closed-loop scenario tests exercise these end-to-end; here each
property is pinned directly (the reference has no such tests — its
SatPos was verified only through position fixes, SURVEY.md section 4)."""

import numpy as np
import pytest

from gps_sdr.config import GPS_C, WEEK_IN_SEC
from gps_sdr.models import orbits

EPH = {
    "weekNum": 312, "Tgd": 1.2e-9, "Toc": 66600.0, "af2": 0.0,
    "af1": 2.5e-12, "af0": -3.1e-4,
    "Crs": 45.0, "deltaN": 4.5e-9, "M0": 1.2, "Cuc": -3.1e-6,
    "e": 0.012, "Cus": 8.2e-6, "sqrtA": np.sqrt(26_560_000.0),
    "Toe": 66600.0, "Cic": 1.1e-7, "omegaBig": -2.4, "Cis": -6.0e-8,
    "i0": 0.96, "Crc": 210.0, "omegaSmall": 0.7, "omegaDot": -8.0e-9,
    "IDOT": 2.0e-10,
}
TOW = 11101  # subframe start at (TOW-1)*6 = 66600 s = Toe


def test_kepler_solver():
    for e in (0.0, 0.005, 0.03):
        M = np.linspace(-np.pi, np.pi, 17)
        E = orbits.kepler_E(M, e)
        np.testing.assert_allclose(E - e * np.sin(E), M, atol=1e-13)


def test_cross_time_wraps_half_week():
    assert orbits.cross_time(WEEK_IN_SEC / 2 + 10) == pytest.approx(
        -WEEK_IN_SEC / 2 + 10)
    assert orbits.cross_time(-WEEK_IN_SEC / 2 - 10) == pytest.approx(
        WEEK_IN_SEC / 2 - 10)
    assert orbits.cross_time(1234.5) == pytest.approx(1234.5)


def test_orbit_radius_and_speed():
    x, y, z, _ = orbits.ecef_coord(TOW, EPH)
    r = np.sqrt(x * x + y * y + z * z)
    a = EPH["sqrtA"] ** 2
    # r = a(1 - e cosE) + harmonic corrections: within a*e + |corr|
    assert abs(r - a) < a * EPH["e"] + 300.0
    vx, vy, vz = orbits.sat_velocity(TOW, EPH)
    speed = np.sqrt(vx * vx + vy * vy + vz * vz)
    # GPS inertial orbital speed ~3.87 km/s; ECEF adds earth rotation
    assert 2500.0 < speed < 4500.0


def test_relativistic_correction_magnitude_and_phase():
    """dtr = F e sqrtA sinE: bounded by |F| e sqrtA and varying along
    the orbit (gpslib.py:589-606 two-pass evaluation)."""
    bound = 4.442807633e-10 * EPH["e"] * EPH["sqrtA"]   # ~27 ns here
    vals = []
    for k in range(0, 7200, 600):   # sample half an orbit
        _, _, _, dtsv_rel = orbits.ecef_coord(TOW, EPH, dt_from_tow=k * 6)
        _, _, _, dtsv_no = orbits.ecef_coord(TOW, EPH, dt_from_tow=k * 6,
                                             rel_corr=False)
        vals.append(dtsv_rel - dtsv_no)
    vals = np.asarray(vals)
    assert np.all(np.abs(vals) <= bound * 1.01)
    assert vals.max() > 0.3 * bound and vals.min() < -0.3 * bound
    # ~27 ns is ~8 m of pseudorange: ignoring it would break the 5 m SD
    assert bound * GPS_C > 5.0


def test_sv_clock_polynomial():
    t = EPH["Toc"] + 100.0
    dtsv = orbits.sv_clock_correction(t, EPH)
    expect = (EPH["af0"] + EPH["af1"] * 100.0 - EPH["Tgd"])
    assert dtsv == pytest.approx(expect, abs=1e-15)


def test_earth_rotation_during_orbit():
    """Over one orbital period the ECEF track must NOT close (the earth
    rotated underneath); over a sidereal-ish 2 orbits it nearly does."""
    x0, y0, z0, _ = orbits.ecef_coord(TOW, EPH)
    period = 2 * np.pi / (np.sqrt(orbits.MU_EARTH) / EPH["sqrtA"] ** 3)
    x1, y1, z1, _ = orbits.ecef_coord(TOW, EPH, dt_from_tow=period)
    d_one = np.linalg.norm([x1 - x0, y1 - y0, z1 - z0])
    assert d_one > 1_000_000.0


def test_gps_abs_time_rollover():
    t = orbits.gps_abs_time(TOW, EPH)
    weeks = (EPH["weekNum"] + 2 * 1024)
    assert abs(t - (weeks * WEEK_IN_SEC + 66600.0)) < 1.0
