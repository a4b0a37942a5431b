"""Position/velocity Kalman track filter (runtime/trackfilter.py).

Unit behavior on synthetic measurements, then the moving-receiver
capture end-to-end: the filtered track must beat the raw fixes' RMS
error against the true trajectory — the fusion payoff of having real
fix covariances ((J'WJ)^-1) and carrier-derived velocities, neither of
which the reference computes.
"""

import numpy as np
import pytest

from gps_sdr.runtime.trackfilter import TrackFilter


def test_static_convergence():
    rng = np.random.default_rng(1)
    tf = TrackFilter(q_accel=0.05)
    truth = np.array([100.0, -50.0, 20.0])
    r = np.eye(3) * 25.0
    for i in range(200):
        z = truth + rng.normal(scale=5.0, size=3)
        assert tf.update_pos(i * 0.032, z, r)
    assert np.linalg.norm(tf.pos - truth) < 2.5
    assert np.linalg.norm(tf.vel) < 0.5


def test_constant_velocity_tracking_and_fusion():
    """Velocity updates must sharpen the track beyond position-only."""
    rng = np.random.default_rng(2)
    v = np.array([10.0, -3.0, 1.0])
    r_pos = np.eye(3) * 64.0
    r_vel = np.eye(3) * 0.01

    def run(use_vel):
        tf = TrackFilter(q_accel=0.5)
        errs = []
        for i in range(300):
            t = i * 0.032
            truth = v * t
            tf.update_pos(t, truth + rng.normal(scale=8.0, size=3),
                          r_pos)
            if use_vel and i % 32 == 31:
                tf.update_vel(t, v + rng.normal(scale=0.1, size=3),
                              r_vel)
            if i > 150:
                errs.append(np.linalg.norm(tf.pos - truth))
        return np.mean(errs), tf

    err_pos_only, _ = run(False)
    err_fused, tf = run(True)
    assert err_fused < err_pos_only
    assert err_fused < 2.5
    assert np.linalg.norm(tf.vel - v) < 0.15


def test_innovation_gate_rejects_outliers():
    tf = TrackFilter(q_accel=0.1)
    r = np.eye(3) * 4.0
    for i in range(100):
        assert tf.update_pos(i * 0.032, np.zeros(3), r)
    # a 500 m teleport is > 6 sigma against a converged track
    assert not tf.update_pos(3.3, np.array([500.0, 0, 0]), r)
    assert np.linalg.norm(tf.pos) < 1.0


def _run_capture(cfg):
    from gps_sdr.runtime.session import Session
    from gps_sdr.runtime.sources import replay_blocks
    from tests.test_velocity import _capture_path

    session = Session(cfg)
    session.run_source(replay_blocks(_capture_path(), cfg))
    return session.evaluator


def _err_vs_truth(rows, scn, n_skip):
    from gps_sdr.utils.gpstime import gps_datetime

    t0 = gps_datetime(scn.tow0, scn.week).timestamp() + 0.25
    t = np.array([r[0] for r in rows[n_skip:]])
    pos = np.array([list(r)[1:4] for r in rows[n_skip:]])
    return pos - (scn.rec_ecef + (t - t0)[:, None] * scn.rec_vel)


def test_moving_capture_filtered_track():
    """End-to-end on the 13 m/s moving capture with RAW (unsmoothed)
    fixes: the filter's fusion of honest fix covariances with the
    carrier velocities must cut the truth-relative RMS by well over
    2x.  (With carrier smoothing on, fixes are already quiet and
    bias-dominated — the noise-reduction test belongs to the raw
    configuration.)"""
    from tests.test_velocity import CFG, _scenario

    cfg = CFG.replace(carrier_smoothing=0, track_filter_q=1.0)
    ev = _run_capture(cfg)
    scn = _scenario()
    assert len(ev.filtered) >= 0.9 * len(ev.positions)
    skip = 64                      # 2 s of filter convergence
    raw = float(np.sqrt(np.mean(np.sum(
        _err_vs_truth(ev.positions, scn, skip) ** 2, axis=1))))
    filt = float(np.sqrt(np.mean(np.sum(
        _err_vs_truth(ev.filtered, scn, skip) ** 2, axis=1))))
    assert filt < 0.5 * raw, (f"filtered {filt:.2f} m vs raw "
                              f"{raw:.2f} m")
    assert filt < 8.0, f"filtered RMS {filt:.2f} m"
    v_end = np.array(ev.filtered[-1][4:])
    assert np.linalg.norm(v_end - scn.rec_vel) < 0.5


def test_outage_coasting_bridges_gap():
    """A mid-run interval with too few satellites for a fix must yield
    track-filter PREDICTIONS (ev.coasted) near the trajectory instead
    of a silent gap — the reference stops producing positions."""
    from gps_sdr.runtime.evaluator import EpochInput, Evaluator
    from gps_sdr.runtime.session import Session
    from gps_sdr.runtime.sources import replay_blocks
    from tests.test_velocity import CFG, _capture_path, _scenario

    cfg = CFG.replace(track_filter_q=1.0)
    rec_session = Session(cfg, record_epochs_to="keep")
    rec_session.run_source(replay_blocks(_capture_path(), cfg))
    records = rec_session.records
    # find the records that produced fixes (tail of the run) and
    # starve two mid-tail intervals down to 2 satellites
    n_fix_first = next(i for i, s in enumerate(rec_session.summaries)
                       if s["n_fixes"] > 0)
    ev = Evaluator(cfg)
    n_before = None
    for i, rec in enumerate(records):
        e = EpochInput(*rec)
        if n_fix_first + 3 <= i <= n_fix_first + 4:
            keep = sorted(e.code_phases)[:2]
            e = EpochInput(
                e.skipped_samples, e.frames,
                {s: e.code_phases[s] for s in keep},
                {s: e.carrier_freqs[s] for s in keep
                 if e.carrier_freqs and s in e.carrier_freqs}
                if e.carrier_freqs else None)
            if n_before is None:
                n_before = len(ev.coasted)
        ev.process(e)
    assert len(ev.coasted) >= n_before + 2, "no coasted predictions"
    scn = _scenario()
    from gps_sdr.utils.gpstime import gps_datetime
    t0 = gps_datetime(scn.tow0, scn.week).timestamp() + 0.25
    for row in ev.coasted[n_before:]:
        truth = scn.rec_ecef + (row[0] - t0) * scn.rec_vel
        err = np.linalg.norm(np.array(row[1:4]) - truth)
        assert err < 25.0, f"coasted {err:.1f} m off the trajectory"
    # fixes resumed and re-anchored the filter after the outage
    assert len(ev.filtered) > 0
    assert ev.positions


def test_filter_with_carrier_smoothing_stays_healthy():
    """With carrier smoothing the fixes carry EMA-correlated noise; the
    evaluator inflates R by the window so the innovation gate must not
    starve and the filtered track must stay at least as tight as the
    raw one."""
    from tests.test_velocity import CFG, _scenario

    cfg = CFG.replace(track_filter_q=1.0)       # smoothing 64 inherited
    ev = _run_capture(cfg)
    scn = _scenario()
    assert len(ev.filtered) >= 0.9 * len(ev.positions), (
        f"gate starved: {len(ev.filtered)}/{len(ev.positions)}")
    # the x64-inflated R stretches the filter's memory: compare tails
    # (last ~14 s), past both the fix transient and the filter's own
    skip = max(len(ev.filtered) - 450, 64)
    raw = _err_vs_truth(ev.positions, scn, skip)
    filt = _err_vs_truth(ev.filtered, scn, skip)

    def rms(e):
        return float(np.sqrt(np.mean(np.sum(e ** 2, axis=1))))

    # bias is common (smoothing lag/geometry); the filter must not add
    # error on already-quiet fixes
    assert rms(filt) <= 1.1 * rms(raw), (
        f"filtered {rms(filt):.2f} m vs raw {rms(raw):.2f} m")
