"""Doppler velocity estimation + moving-receiver closed loop.

The reference tracks every channel's carrier frequency (its FRQ report,
gpslib.py:1124-1131) but never solves velocity, and its only end-to-end
input is a static rooftop capture.  Here: ops/pvt.py solve_velocity
(linear LS over tracked Dopplers), the evaluator's per-second velocity
series, and a moving-receiver scenario through the full DSP chain.

The moving capture is cached under .synth_cache/ (~80 MB).
"""

import os

import numpy as np
import pytest

from gps_sdr.config import GPS_C, L1_FREQ, ReceiverConfig
from gps_sdr.models.scenario import make_scenario
from gps_sdr.models.scenario_jax import DeviceScenarioSynth
from gps_sdr.ops.pvt import solve_velocity
from gps_sdr.runtime.sources import pack_iq, replay_blocks
from gps_sdr.utils.geodesy import enu_to_ecef_vec
from tests.conftest import _SYNTH_CACHE

# carrier smoothing has zero lag on real dynamics (the carrier tracks
# the motion), so it is the correct configuration for a moving
# receiver — and this doubles as the Hatch filter's moving-case test.
# Its EMA correlates fix noise over ~2 s (64 blocks), so the fix span
# must cover many correlation times for the statistics below; seed 35
# gives a sound constellation (GDOP 3.2 — seed 33 hit GDOP 7.5 with
# x-DOP 5.2 and drowned the track in geometry noise).
CFG = ReceiverConfig(carrier_smoothing=64)
SEC = 48.0
VEL_ENU = (12.0, -5.0, 0.0)          # ~13 m/s ground speed


def test_solve_velocity_exact_recovery():
    """Synthesized Dopplers from the model itself: exact recovery of
    velocity and clock drift (the solve is linear)."""
    rng = np.random.default_rng(0)
    rec = np.array([4141645.0, 604760.0, 4796720.0])
    n = 7
    u = rng.normal(size=(3, n))
    u /= np.linalg.norm(u, axis=0)
    sat_pos = rec[:, None] + 2.2e7 * np.abs(u)
    sat_vel = rng.normal(scale=2000.0, size=(3, n))
    v_true = np.array([10.0, -4.0, 2.5])
    y_true = 1.7e-6
    los = sat_pos - rec[:, None]
    los /= np.linalg.norm(los, axis=0)
    k = L1_FREQ / GPS_C
    f = -k * np.sum((sat_vel - v_true[:, None]) * los, axis=0) \
        - y_true * L1_FREQ
    res = solve_velocity(sat_pos, sat_vel, rec, f, L1_FREQ)
    assert np.allclose(res.vel, v_true, atol=1e-6)
    assert res.clock_drift == pytest.approx(y_true, abs=1e-12)
    assert res.residual < 1e-6
    # under-determined -> None
    assert solve_velocity(sat_pos[:, :3], sat_vel[:, :3], rec, f[:3],
                          L1_FREQ) is None


def _scenario():
    return make_scenario(CFG, n_sats=7, duration_sec=SEC + 12.0,
                         seed=35, rec_vel_enu=VEL_ENU)


def _capture_path():
    os.makedirs(_SYNTH_CACHE, exist_ok=True)
    path = os.path.join(_SYNTH_CACHE, "moving_capture_v2.bin")
    if os.path.exists(path):
        return path
    scn = _scenario()
    dev = DeviceScenarioSynth(scn, noise_std=0.5)
    n_blocks = int(round(SEC / CFG.block_sec))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        done = 0
        while done < n_blocks:
            k = min(CFG.no_sec, n_blocks - done)
            pack_iq(0.13 * np.asarray(dev.chunk(done, k))).tofile(f)
            done += k
    os.replace(tmp, path)
    return path


@pytest.fixture(scope="module")
def replayed():
    from gps_sdr.runtime.session import Session

    path = _capture_path()
    scn = _scenario()
    session = Session(CFG)
    summary = session.run_source(replay_blocks(path, CFG))
    return scn, session, summary


def test_moving_receiver_track(replayed):
    """Fixes must follow the true trajectory rec_ecef + v*(t - t0):
    the fix-series linear fit recovers the velocity, and the mean
    truth-relative error stays meters-class."""
    from gps_sdr.utils.gpstime import gps_datetime

    scn, session, summary = replayed
    ev = session.evaluator
    assert len(ev.positions) >= 100, f"only {len(ev.positions)} fixes"
    t = np.array([p[0] for p in ev.positions])
    pos = np.array([p[1:] for p in ev.positions])
    assert t[-1] - t[0] > 10.0, "fix span too short for the statistics"
    t_rel = t - t[0]
    v_fit = np.array([np.polyfit(t_rel, pos[:, ax], 1)[0]
                      for ax in range(3)])
    v_true = scn.rec_vel
    assert np.linalg.norm(v_fit - v_true) < 1.0, (
        f"fitted velocity {v_fit} vs true {v_true}")
    # truth-relative error: posix time of receiver sample 0 anchors the
    # trajectory (rx_start_offset = 0.25 s after the tow0 epoch)
    t0 = gps_datetime(scn.tow0, scn.week).timestamp() + 0.25
    err = pos - (scn.rec_ecef + (t - t0)[:, None] * scn.rec_vel)
    bias = np.linalg.norm(err.mean(axis=0))
    assert bias < 10.0, f"mean trajectory error {bias:.1f} m"


def test_doppler_velocity_series(replayed):
    """The evaluator's per-second Doppler velocity solves must match
    the true velocity to sub-m/s — far tighter than differentiating
    positions (the classic reason receivers solve velocity from
    carrier, which the reference never does)."""
    scn, session, summary = replayed
    ev = session.evaluator
    assert len(ev.velocities) >= 5, f"only {len(ev.velocities)} solves"
    v = np.array([row[1:] for row in ev.velocities], np.float64)
    v_true = scn.rec_vel
    err = np.linalg.norm(np.median(v, axis=0) - v_true)
    assert err < 0.5, (f"median velocity {np.median(v, axis=0)} vs "
                       f"true {v_true} (err {err:.2f} m/s)")
    # clock drift observed near zero for this unimpaired oscillator
    assert abs(ev.vel_result.clock_drift) < 2e-8


def test_static_velocity_near_zero():
    """On a static capture the velocity series must sit near zero (the
    atmosphere closed-loop capture doubles as the static fixture)."""
    from gps_sdr.runtime.session import Session
    from tests.test_atmos_closed_loop import CFG as ACFG
    from tests.test_atmos_closed_loop import _capture_path as acap

    session = Session(ACFG)
    session.run_source(replay_blocks(acap(), ACFG))
    ev = session.evaluator
    assert len(ev.velocities) >= 3
    v = np.array([row[1:] for row in ev.velocities], np.float64)
    assert np.linalg.norm(np.median(v, axis=0)) < 0.3
