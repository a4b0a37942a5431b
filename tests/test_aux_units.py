"""Edge-path unit tests for the round-2 auxiliary modules: almanac
hints, GPS-time inversion, ENU rotation, RAIM exclusion expiry, track
filter guards, and atmosphere clamps."""

import datetime

import numpy as np
import pytest

from gps_sdr.config import ReceiverConfig
from gps_sdr.models.almanac import (acquisition_hints,
                                    almanac_from_ephem,
                                    predict_visible)
from gps_sdr.models.atmosphere import klobuchar_delay, tropo_delay
from gps_sdr.models.scenario import (DEFAULT_IONO_ALPHA,
                                     DEFAULT_IONO_BETA,
                                     make_scenario)
from gps_sdr.runtime.trackfilter import TrackFilter
from gps_sdr.utils.geodesy import enu_to_ecef_vec, geo_to_ecef
from gps_sdr.utils.gpstime import gps_datetime, gps_week_tow

CFG = ReceiverConfig()


def test_gps_week_tow_inverts_gps_datetime():
    for week, tow in ((312, 11100), (0, 1), (1023, 100800), (500, 7)):
        dt = gps_datetime(tow, week)
        assert gps_week_tow(dt) == (week, tow)
    # timezone-aware datetimes accepted
    dt = gps_datetime(11100, 312).replace(
        tzinfo=datetime.timezone.utc)
    assert gps_week_tow(dt) == (312, 11100)


def test_enu_to_ecef_vec_is_orthonormal_rotation():
    lat, lon = 49.08, 8.31
    e = enu_to_ecef_vec(lat, lon, (1.0, 0.0, 0.0))
    n = enu_to_ecef_vec(lat, lon, (0.0, 1.0, 0.0))
    u = enu_to_ecef_vec(lat, lon, (0.0, 0.0, 1.0))
    for v in (e, n, u):
        assert np.linalg.norm(v) == pytest.approx(1.0)
    assert abs(e @ n) < 1e-12 and abs(e @ u) < 1e-12 \
        and abs(n @ u) < 1e-12
    # up aligns with the geodetic normal: geo_to_ecef along +alt
    p0 = np.array(geo_to_ecef(lat, lon, 0.0))
    p1 = np.array(geo_to_ecef(lat, lon, 100.0))
    assert np.allclose((p1 - p0) / 100.0, u, atol=1e-9)


def test_unhealthy_sv_excluded_from_prediction():
    scn = make_scenario(CFG, n_sats=4, duration_sec=12.0, seed=8)
    alms = {s.prn: almanac_from_ephem(s.eph) for s in scn.sats}
    bad = scn.sats[0].prn
    alms[bad]["almHealth"] = 63
    vis = predict_visible(alms, scn.rec_ecef, scn.tow0)
    assert bad not in {v[0] for v in vis}
    assert len(vis) == 3


def test_acquisition_hints_refuses_thin_prediction():
    scn = make_scenario(CFG, n_sats=3, duration_sec=12.0, seed=8)
    alms = {s.prn: almanac_from_ephem(s.eph) for s in scn.sats}
    prns, bins = acquisition_hints(alms, scn.rec_ecef, scn.tow0)
    assert prns is None and bins is None      # < 4 predicted


def test_raim_exclusion_expires():
    from gps_sdr.models.pseudorange import SatRows
    from gps_sdr.runtime.evaluator import Evaluator

    cfg = ReceiverConfig(raim=True, raim_exclude_sec=10.0)
    ev = Evaluator(cfg)
    ev.raim_excluded = {7: 66700.0}

    def rows(tow):
        n = 2
        return SatRows(
            sat_no=np.array([7, 9]), tow=np.full(n, tow, np.int64),
            pos=np.zeros((n, 3)), t=np.zeros(n),
            week=np.full(n, 312, np.int64),
            cyc=np.zeros(n, np.int64), sigma=np.ones(n))

    # before expiry: PRN 7's rows dropped
    out = ev._raim_drop_excluded(rows(tow=11100))   # tsec 66594
    assert out.sat_no.tolist() == [9]
    # after expiry: exclusion lifted, rows intact
    out = ev._raim_drop_excluded(rows(tow=11120))   # tsec 66714
    assert out.sat_no.tolist() == [7, 9]
    assert ev.raim_excluded == {}


def test_trackfilter_guards():
    tf = TrackFilter(q_accel=1.0)
    # velocity before any position: rejected
    assert not tf.update_vel(0.0, np.zeros(3), np.eye(3))
    assert tf.pos is None and tf.vel is None
    # first position initializes; non-monotonic time is a no-op predict
    assert tf.update_pos(1.0, np.array([1.0, 2.0, 3.0]), np.eye(3))
    assert tf.update_pos(0.5, np.array([1.1, 2.0, 3.0]), np.eye(3))
    assert np.all(np.isfinite(tf.p))


def test_atmosphere_clamps():
    a, b = DEFAULT_IONO_ALPHA, DEFAULT_IONO_BETA
    # low elevation: pierce-point latitude clamps, delay stays finite
    d = klobuchar_delay(a, b, np.deg2rad(80.0), np.deg2rad(0.0),
                        np.deg2rad(1.0), np.deg2rad(0.0), 50400.0)
    assert np.isfinite(d) and 0 < d < 1e-6
    # negative AMP floors at the 5 ns night value x obliquity
    a_neg = (-1e-7, 0.0, 0.0, 0.0)
    el = np.deg2rad(45.0)
    d = klobuchar_delay(a_neg, b, 0.0, 0.0, el, 0.0, 50400.0)
    f = 1.0 + 16.0 * (0.53 - 0.25) ** 3
    assert d == pytest.approx(5e-9 * f)
    # troposphere: elevation floored at 3 deg, height clamped
    assert tropo_delay(np.deg2rad(-5.0)) == tropo_delay(np.deg2rad(3.0))
    assert np.isfinite(tropo_delay(np.deg2rad(45.0), 99999.0))


def test_dop_reported_and_matches_geometry():
    """One pipeline fix interval must report GDOP/PDOP/HDOP/VDOP
    consistent with the constellation geometry (seed 35 was measured
    at GDOP 3.2 when picking scenario seeds)."""
    from gps_sdr.runtime.session import Session
    from gps_sdr.runtime.sources import replay_blocks
    from tests.test_raim import _capture_path

    cfg = ReceiverConfig()
    s = Session(cfg)
    s.run_source(replay_blocks(_capture_path(), cfg))
    dop = s.evaluator.dop
    assert dop is not None
    g, p, h, v = dop
    assert 1.0 < g < 10.0
    assert p < g                       # clock term adds to GDOP
    assert np.isclose(np.hypot(h, v), p, rtol=1e-9)
    assert s.summaries[-1]["dop"] == dop
