"""Atmospheric models, SF4/5 page decode, and almanac warm-start.

The reference has no atmospheric model (its README attributes rare
systematic deviations >20 m to that omission, README.md:26) and decodes
nothing from subframes 4/5 (gpslib.py:373-377).  These tests pin the
beyond-reference capabilities: Klobuchar/Saastamoinen corrections
closing the loop against a simulator that injects the same physics, and
almanac-page decode driving visible-satellite prediction.
"""

import numpy as np
import pytest

from gps_sdr.config import GPS_C, L1_FREQ, ReceiverConfig
from gps_sdr.models import navmsg
from gps_sdr.models.almanac import (almanac_from_ephem,
                                    ephem_from_almanac,
                                    predict_visible)
from gps_sdr.models.atmosphere import (azim_elev_batch,
                                       klobuchar_delay, tropo_delay)
from gps_sdr.models.scenario import (DEFAULT_IONO_ALPHA,
                                     DEFAULT_IONO_BETA,
                                     make_scenario)

CFG = ReceiverConfig()
LAT, LON = np.deg2rad(49.08), np.deg2rad(8.31)
NOON = 50400.0 - 4.32e4 * LON / np.pi    # local 14:00 at the pierce point


def test_klobuchar_properties():
    a, b = DEFAULT_IONO_ALPHA, DEFAULT_IONO_BETA
    el = np.deg2rad(40.0)
    az = np.deg2rad(180.0)
    # nighttime floor: 5 ns times the obliquity factor
    night = klobuchar_delay(a, b, LAT, LON, el, az, 3600.0)
    f = 1.0 + 16.0 * (0.53 - 40.0 / 180.0) ** 3
    assert night == pytest.approx(5e-9 * f, rel=1e-12)
    # daytime mid-latitude delay: meters-class, larger than night
    day = klobuchar_delay(a, b, LAT, LON, el, az, NOON)
    assert 5e-9 < day < 50e-9
    assert day > 2 * night
    # obliquity: lower elevation, longer slant path
    els = np.deg2rad(np.array([10.0, 30.0, 60.0, 90.0]))
    d = klobuchar_delay(a, b, LAT, LON, els, az, NOON)
    assert np.all(np.diff(d) < 0)
    # broadcasts over arrays
    assert d.shape == (4,)


def test_tropo_properties():
    # zenith delay at sea level: the textbook ~2.3-2.6 m
    z = tropo_delay(np.deg2rad(90.0)) * GPS_C
    assert 2.2 < z < 2.7
    # monotonic in elevation; ~1/sin(el) growth
    els = np.deg2rad(np.array([5.0, 10.0, 30.0, 90.0]))
    d = tropo_delay(els, 150.0) * GPS_C
    assert np.all(np.diff(d) < 0)
    assert d[0] > 5 * d[-1] * 0.8
    # thinner atmosphere above the receiver
    assert tropo_delay(np.deg2rad(45.0), 2000.0) < \
        tropo_delay(np.deg2rad(45.0), 0.0)


def test_scenario_injection_matches_evaluator_correction():
    """The delay the simulator injects must equal the correction the
    evaluator computes from the same coefficients and geometry — the
    cancellation the closed loop relies on (different code paths:
    scenario.sat_states works at emission-time satellite coordinates,
    the evaluator at the decoded positions)."""
    scn = make_scenario(CFG, n_sats=5, duration_sec=18.0, seed=2,
                        iono=True, tropo=True)
    t = scn.t_rx0 + np.array([0.0, 5.0, 10.0])
    for sat in scn.sats:
        tau_on, _ = scn.sat_states(t, sat)
        scn.iono_alpha, alpha = None, scn.iono_alpha
        scn.model_tropo = False
        tau_off, _ = scn.sat_states(t, sat)
        scn.iono_alpha = alpha
        scn.model_tropo = True
        injected = tau_on - tau_off

        from gps_sdr.models import orbits
        x, y, z, _ = orbits.ecef_coord(
            scn.tow0, sat.eph,
            dt_from_tow=t - orbits.tsv_of_tow(scn.tow0))
        el, az = azim_elev_batch(scn.rec_ecef,
                                 np.stack([x, y, z], axis=1))
        expect = (klobuchar_delay(scn.iono_alpha, scn.iono_beta, LAT,
                                  LON, el, az, np.mod(t, 86400.0))
                  + tropo_delay(el, scn.rec_geo[2]))
        # emission-time vs reception-time geometry differ by ~70 ms of
        # satellite motion: sub-permille of the delay itself
        assert np.all(np.abs(injected - expect) < 0.02e-9 +
                      0.01 * expect)


def _frames_of(scn, sat, tow):
    off = (tow - scn.tow0) * 300
    bits01 = ((sat.nav_stream[off:off + 300] + 1) // 2).astype(np.int8)
    return navmsg.decode_subframe(bits01)


def test_page18_broadcast_decodes():
    scn = make_scenario(CFG, n_sats=4, duration_sec=40.0, seed=5,
                        iono=True)
    sat = scn.sats[0]
    tow = next(t for t in range(scn.tow0, scn.tow0 + 5)
               if (t - 1) % 5 + 1 == 4)
    sf = _frames_of(scn, sat, tow)
    assert sf is not None and sf["ID"] == 4
    assert sf["svID"] == navmsg.IONO_PAGE_SVID
    for i in range(4):
        assert sf[f"alpha{i}"] == pytest.approx(scn.iono_alpha[i],
                                                abs=1e-20)
        assert sf[f"beta{i}"] == pytest.approx(scn.iono_beta[i],
                                               abs=1e-9)
    assert sf["dtLS"] == 18


def test_almanac_broadcast_and_visibility_prediction():
    """Decoded almanac pages must predict every scenario satellite
    above the horizon with Doppler within a sweep bin or two of the
    truth — the warm start the reference can never do."""
    scn = make_scenario(CFG, n_sats=6, duration_sec=60.0, seed=7,
                        broadcast_almanac=True)
    sat = scn.sats[0]
    alms = {}
    for tow in range(scn.tow0, scn.tow0 + 10):
        if (tow - 1) % 5 + 1 != 5:
            continue
        sf = _frames_of(scn, sat, tow)
        assert sf is not None and sf["ID"] == 5
        if 1 <= sf.get("svID", 0) <= 32:
            alms[sf["svID"]] = sf
    assert len(alms) >= 2        # two SF5 slots in 10 subframes

    # fill in the remaining pages straight from the page tables (the
    # broadcast cycles at 30 s/page; decoding all of them end-to-end
    # is the 60 s test above's job at scale)
    for s in scn.sats:
        alms.setdefault(s.prn, {**almanac_from_ephem(s.eph),
                                "svID": s.prn})

    vis = predict_visible(alms, scn.rec_ecef, scn.tow0)
    got = {prn: (el, dop) for prn, el, dop in vis}
    for s in scn.sats:
        assert s.prn in got, f"PRN {s.prn} not predicted visible"
        el_deg, dop = got[s.prn]
        ts = scn.t_rx0 + np.array([-0.5, 0.5])
        tau, _ = scn.sat_states(ts, s)
        dop_true = -L1_FREQ * (tau[1] - tau[0])
        assert abs(dop - dop_true) < 150.0, (
            f"PRN {s.prn}: predicted {dop:.0f} Hz, true {dop_true:.0f}")
        assert el_deg > 5.0


def test_almanac_warm_start_acquisition():
    """Receiver.warm_start: an almanac + rough position/time shrinks
    the cold sweep to the predicted-visible PRNs over a narrowed
    Doppler grid, and still acquires every satellite.  The reference
    always sweeps all 31 PRNs x the full band."""
    from gps_sdr.models.scenario import synth_scenario_blocks
    from gps_sdr.runtime.receiver import Receiver
    from tests.conftest import cached_synth

    scn = make_scenario(CFG, n_sats=6, duration_sec=8.0, seed=13)
    block = cached_synth(
        "warmstart_block_v1",
        lambda: synth_scenario_blocks(scn, 0, 1, noise_std=0.5))[0]
    truth = {s.prn for s in scn.sats}
    alms = {s.prn: almanac_from_ephem(s.eph) for s in scn.sats}

    rec = Receiver(CFG)
    assert rec.warm_start(alms, scn.rec_ecef, scn.tow0)
    prns, bins = rec.warm_hints
    full = len(list(CFG.prns)) * len(CFG.doppler_bins)
    assert set(prns) == truth
    assert len(prns) * len(bins) < 0.5 * full, "grid barely shrank"
    rec._serve_sweep_all(block)
    assert truth <= set(rec.slots.active), (
        f"warm sweep missed {truth - set(rec.slots.active)}")
    assert rec.warm_hints is None        # one-shot

    # bad hints (PRNs not on the air) fall back to the full grid
    rec2 = Receiver(CFG)
    wrong = [p for p in range(2, 33) if p not in truth][:6]
    rec2.warm_hints = (wrong, bins)
    rec2._serve_sweep_all(block)
    assert truth <= set(rec2.slots.active), "fallback did not engage"


def test_almanac_cache_roundtrip(tmp_path):
    from gps_sdr.utils.io import load_almanac, save_almanac

    scn = make_scenario(CFG, n_sats=3, duration_sec=12.0, seed=4)
    alms = {s.prn: almanac_from_ephem(s.eph) for s in scn.sats}
    iono = {"alpha": DEFAULT_IONO_ALPHA, "beta": DEFAULT_IONO_BETA}
    p = str(tmp_path / "almanac.json")
    save_almanac(p, alms, iono_params=iono)
    back, iono_back = load_almanac(p)
    assert set(back) == set(alms)
    assert iono_back == iono
    vis = predict_visible(back, scn.rec_ecef, scn.tow0)
    assert {v[0] for v in vis} >= set(alms)
    # stale cache rejected
    assert load_almanac(p, max_age_sec=-1) == ({}, None)


def test_session_warm_start_plumbing(tmp_path):
    """Session + CLI: the almanac cache preloads the evaluator (iono
    coefficients included) and --warm-start arms the receiver sweep."""
    from gps_sdr.cli import _arm_warm_start
    from gps_sdr.runtime.session import Session
    from gps_sdr.utils.io import save_almanac

    scn = make_scenario(CFG, n_sats=5, duration_sec=12.0, seed=9,
                        iono=True)
    alms = {s.prn: almanac_from_ephem(s.eph) for s in scn.sats}
    p = str(tmp_path / "alm.json")
    save_almanac(p, alms, iono_params={"alpha": scn.iono_alpha,
                                       "beta": scn.iono_beta})
    session = Session(CFG, almanac_cache_path=p)
    assert set(session.evaluator.almanacs) == set(alms)
    assert session.evaluator.iono_params["alpha"] == scn.iono_alpha
    lat, lon, alt = scn.rec_geo
    _arm_warm_start(f"{lat},{lon},{alt},{scn.tow0}", session)
    prns, bins = session.receiver.warm_hints
    assert set(prns) == {s.prn for s in scn.sats}


def test_almanac_orbit_accuracy():
    """Almanac-propagated position within a few km of the precise
    ephemeris (IS-GPS-200 quotes ~1-2 km typical almanac error; ours
    drops only the harmonic terms + deltaN/IDOT and quantizes)."""
    from gps_sdr.models import orbits
    scn = make_scenario(CFG, n_sats=3, duration_sec=12.0, seed=11)
    for s in scn.sats:
        alm = almanac_from_ephem(s.eph)
        # round-trip through the broadcast quantization
        tx = navmsg.encode_subframe(5, {**alm, "dataID": 1,
                                        "svID": s.prn}, tow=scn.tow0 + 4)
        dec = navmsg.decode_subframe(tx)
        eph_c = ephem_from_almanac(dec, week_num=scn.week)
        x, y, z, _ = orbits.ecef_coord(scn.tow0, s.eph, dt_from_tow=10.0)
        xc, yc, zc, _ = orbits.ecef_coord(scn.tow0, eph_c,
                                          dt_from_tow=10.0)
        err = np.linalg.norm([x - xc, y - yc, z - zc])
        assert err < 5000.0, f"PRN {s.prn}: almanac error {err:.0f} m"
