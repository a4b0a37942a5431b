"""Geodesy and GPS-time utility tests."""

import numpy as np

from gps_sdr.utils import geodesy, gpstime


def test_geo_ecef_roundtrip():
    for lat, lon, alt in [(49.082961, 8.307581, 150.0), (0.0, 0.0, 0.0),
                          (-45.3, 170.1, 2000.0), (89.0, -120.0, 10.0)]:
        x, y, z = geodesy.geo_to_ecef(lat, lon, alt)
        lat2, lon2, alt2 = geodesy.ecef_to_geo((x, y, z))
        assert abs(lat2 - lat) < 1e-9
        assert abs(lon2 - lon) < 1e-9
        assert abs(alt2 - alt) < 1e-4


def test_ecef_known_point():
    # equator/prime meridian at 0 height is (a, 0, 0)
    x, y, z = geodesy.geo_to_ecef(0.0, 0.0, 0.0)
    assert abs(x - geodesy.WGS84_A) < 1e-6 and abs(y) < 1e-6 and abs(z) < 1e-6
    # north pole at 0 height is (0, 0, b)
    x, y, z = geodesy.geo_to_ecef(90.0, 0.0, 0.0)
    assert abs(z - geodesy.WGS84_B) < 1e-6 and abs(x) < 1e-3


def test_azim_elev():
    obs = np.array(geodesy.geo_to_ecef(45.0, 10.0, 0.0))
    # satellite straight up: scale observer vector outward
    sat_up = obs * (1 + 2e7 / np.linalg.norm(obs))
    elev, _ = geodesy.ecef_to_azim_elev(obs, sat_up)
    assert abs(elev - 90.0) < 0.2
    # a satellite due north at similar latitude+height has azimuth ~ 0
    sat_n = np.array(geodesy.geo_to_ecef(60.0, 10.0, 2.0e7))
    elev, azim = geodesy.ecef_to_azim_elev(obs, sat_n)
    assert abs(azim) < 1.0


def test_local_offsets():
    home = (49.0, 8.3, 100.0)
    # 0.001 deg north is ~111.2 m north, ~0 east
    east, north = geodesy.local_offsets_m(home, (49.001, 8.3, 100.0))
    assert abs(east) < 1e-6
    assert 110.0 < north < 112.5
    east, north = geodesy.local_offsets_m(home, (49.0, 8.301, 100.0))
    assert abs(north) < 1e-6
    assert 72.0 < east < 74.5  # ~111.3*cos(49 deg)


def test_gps_datetime():
    # week 0, tow 1 -> GPS epoch minus leap seconds
    d = gpstime.gps_datetime(1, -2048)  # cancel the rollover era
    assert d.year == 1980 and d.month == 1 and d.day == 5
    s = gpstime.gps_time_str(1, -2048)
    assert "UTC" in s
