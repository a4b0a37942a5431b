"""PVT solver tests on synthetic geometry with known receiver position."""

import numpy as np
import pytest

from gps_sdr.config import GPS_C, OMEGA_EARTH
from gps_sdr.ops.pvt import solve_fix
from gps_sdr.utils.geodesy import geo_to_ecef

REC = np.array(geo_to_ecef(49.082961, 8.307581, 150.0))
R_ORBIT = 26_560_000.0


def _sat_constellation(n, seed=0):
    """n satellites on the GPS shell, all above the horizon at REC."""
    rng = np.random.default_rng(seed)
    sats = []
    up = REC / np.linalg.norm(REC)
    while len(sats) < n:
        v = rng.standard_normal(3)
        v /= np.linalg.norm(v)
        p = R_ORBIT * (0.35 * v + up)
        p *= R_ORBIT / np.linalg.norm(p)
        elev_ok = np.dot(p - REC, up) / np.linalg.norm(p - REC) > 0.15
        if elev_ok:
            sats.append(p)
    return np.stack(sats, axis=1)  # [3, n]


def _delays(sat_pos, clock_bias=0.0317):
    """Receive timestamps including earth-rotation during flight and an
    arbitrary common receiver clock bias (which the solver absorbs)."""
    n = sat_pos.shape[1]
    d = np.empty(n)
    for i in range(n):
        # iterate the Sagnac effect: receiver frame rotates while the
        # signal is in flight
        tau = np.linalg.norm(sat_pos[:, i] - REC) / GPS_C
        for _ in range(3):
            ang = OMEGA_EARTH * tau
            # rotate the satellite position by -ang about z (ECEF frame at
            # receive time)
            c, s = np.cos(ang), np.sin(ang)
            x = c * sat_pos[0, i] + s * sat_pos[1, i]
            y = -s * sat_pos[0, i] + c * sat_pos[1, i]
            tau = np.linalg.norm(np.array([x, y, sat_pos[2, i]]) - REC) / GPS_C
        d[i] = tau + clock_bias
    return d


@pytest.mark.parametrize("n_sat", [4, 6, 9])
def test_fix_recovers_position(n_sat):
    sat_pos = _sat_constellation(n_sat)
    delays = _delays(sat_pos)
    fix = solve_fix(sat_pos, delays, max_it=15, max_residual=1e-8)
    assert fix.residual < 1e-6
    err = np.linalg.norm(fix.rec_pos[1:] - REC)
    assert err < 0.5, f"position error {err:.3f} m"
    # recovered propagation time of satellite 0
    tau0 = np.linalg.norm(sat_pos[:, 0] - REC) / GPS_C
    assert abs(fix.rec_pos[0] / GPS_C - tau0) < 1e-7


def test_fix_weighted_downweights_bad_sat():
    sat_pos = _sat_constellation(7, seed=2)
    delays = _delays(sat_pos)
    delays[3] += 300.0 / GPS_C  # 300 m error on one satellite
    std = np.full(7, 3.0)
    std[3] = 300.0
    fix_w = solve_fix(sat_pos, delays, std_dev=std)
    fix_u = solve_fix(sat_pos, delays)
    err_w = np.linalg.norm(fix_w.rec_pos[1:] - REC)
    err_u = np.linalg.norm(fix_u.rec_pos[1:] - REC)
    assert err_w < err_u
    assert err_w < 5.0


def test_fix_three_sats_with_height():
    sat_pos = _sat_constellation(3, seed=4)
    delays = _delays(sat_pos)
    fix = solve_fix(sat_pos, delays, height=150.0, height_dev=1.0,
                    max_it=20)
    err = np.linalg.norm(fix.rec_pos[1:] - REC)
    assert err < 10.0, f"3-sat height-constrained error {err:.3f} m"


def test_batch_matches_single():
    """solve_fix_batch must converge to the same optima as per-epoch
    solve_fix (the evaluator batches epochs per satellite count)."""
    from gps_sdr.ops.pvt import solve_fix_batch

    rng = np.random.default_rng(9)
    sat_pos = np.stack([_sat_constellation(6, seed=10 + i)
                        for i in range(5)])           # [E, 3, n]
    delays = np.stack([
        _delays(sat_pos[i], clock_bias=0.03 + 0.001 * i)
        for i in range(5)])
    stds = rng.uniform(1.0, 5.0, size=(5, 6))

    batch = solve_fix_batch(sat_pos, delays, std_dev=stds)
    for i, fb in enumerate(batch):
        fs = solve_fix(sat_pos[i], delays[i], std_dev=stds[i])
        np.testing.assert_allclose(fb.rec_pos, fs.rec_pos, atol=1e-5)
        np.testing.assert_allclose(fb.range_est, fs.range_est, atol=1e-4)
        np.testing.assert_allclose(fb.meas_delay, fs.meas_delay,
                                   atol=1e-5)
        # the Sagnac term is re-linearized each iteration, so the update
        # norm plateaus ~1e-7 rather than hitting the 1e-8 gate exactly
        assert fb.residual < 1e-5


def test_batch_matches_single_height_mode():
    from gps_sdr.ops.pvt import solve_fix_batch

    sat_pos = np.stack([_sat_constellation(3, seed=20 + i)
                        for i in range(3)])
    delays = np.stack([_delays(sat_pos[i]) for i in range(3)])
    batch = solve_fix_batch(sat_pos, delays, height=150.0,
                            height_dev=1.0, max_it=20)
    for i, fb in enumerate(batch):
        fs = solve_fix(sat_pos[i], delays[i], height=150.0,
                       height_dev=1.0, max_it=20)
        np.testing.assert_allclose(fb.rec_pos, fs.rec_pos, atol=1e-4)


def test_batch_warm_start_shared():
    """A shared warm start must not change the converged optimum."""
    from gps_sdr.ops.pvt import solve_fix_batch

    sat_pos = np.stack([_sat_constellation(5, seed=30 + i)
                        for i in range(4)])
    delays = np.stack([_delays(sat_pos[i]) for i in range(4)])
    cold = solve_fix_batch(sat_pos, delays)
    warm = solve_fix_batch(sat_pos, delays,
                           rec_pos0=np.array([0.0, *REC]))
    for fc, fw in zip(cold, warm):
        np.testing.assert_allclose(fc.rec_pos, fw.rec_pos, atol=1e-5)


def test_fix_warm_start_converges_faster():
    sat_pos = _sat_constellation(5, seed=6)
    delays = _delays(sat_pos)
    cold = solve_fix(sat_pos, delays)
    warm = solve_fix(sat_pos, delays, rec_pos0=np.array([0.0, *REC]))
    assert warm.n_iter <= cold.n_iter
    assert np.linalg.norm(warm.rec_pos[1:] - REC) < 0.5


def test_clock_rate_fix_removes_skew_bias():
    """Sample-clock skew scales every delay DIFFERENCE by (1+y) — an
    elevation-correlated pseudorange distortion no per-epoch clock bias
    can absorb (the reference demands SDR_FREQCORR instead,
    README.md:204-217).  Applying the known y via clock_rate_fix must
    restore the unskewed fix."""
    y = 2.0e-6
    sat_pos = _sat_constellation(8, seed=7)
    d = _delays(sat_pos)
    d_skew = d[0] + (d - d[0]) * (1.0 + y)
    biased = solve_fix(sat_pos, d_skew)
    fixed = solve_fix(sat_pos, d_skew, clock_rate_fix=y)
    err_b = np.linalg.norm(biased.rec_pos[1:] - REC)
    err_f = np.linalg.norm(fixed.rec_pos[1:] - REC)
    assert err_b > 2.0, f"skew bias unexpectedly small: {err_b:.2f} m"
    assert err_f < 0.5, f"corrected error {err_f:.3f} m"


def test_clock_rate_free_unknown_recovers_y():
    """With >= 5 sats and noise-free delays the free rate unknown must
    recover the injected skew and the position."""
    y = 2.0e-6
    sat_pos = _sat_constellation(9, seed=8)
    d = _delays(sat_pos)
    d_skew = d[0] + (d - d[0]) * (1.0 + y)
    fix = solve_fix(sat_pos, d_skew, clock_rate=True, max_it=25)
    assert abs(fix.clock_rate - y) < 1e-7, fix.clock_rate
    assert np.linalg.norm(fix.rec_pos[1:] - REC) < 0.5


def test_clock_rate_batch_matches_single():
    from gps_sdr.ops.pvt import solve_fix_batch

    y = 1.5e-6
    sat_pos = np.stack([_sat_constellation(7, seed=40 + i)
                        for i in range(3)])
    delays = np.stack([_delays(sat_pos[i]) for i in range(3)])
    delays = delays[:, :1] + (delays - delays[:, :1]) * (1.0 + y)
    batch = solve_fix_batch(sat_pos, delays, clock_rate=True, max_it=25)
    for i, fb in enumerate(batch):
        fs = solve_fix(sat_pos[i], delays[i], clock_rate=True, max_it=25)
        np.testing.assert_allclose(fb.rec_pos, fs.rec_pos, atol=1e-4)
        assert abs(fb.clock_rate - fs.clock_rate) < 1e-9
