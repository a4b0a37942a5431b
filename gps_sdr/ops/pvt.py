"""Position fixing: iterated weighted Gauss-Newton least squares.

Replaces the reference's leastSquaresPos family (src/gpslib.py:1641-1791).
Solves for receiver position and the propagation time of satellite 0
from *relative* pseudoranges — time delays are differenced against
satellite 0 and a clock unknown t0 absorbs the common bias
(gpslib.py:1701-1703), exactly the reference's formulation:

  minimize || range_i(pos) - c*t0 - c*(d_i - d_0) ||_W

with the Sagnac (earth-rotation during signal flight) displacement
applied to the satellite positions each iteration (rotEarth,
gpslib.py:1670-1675), optional 1/sigma^2 weighting, and an optional
WGS84-ellipsoid height constraint enabling 3-satellite fixes
(gpslib.py:1740-1791).

Host float64.  The solve is a handful of 4x4 normal equations per
second — bookkeeping next to the IQ stream.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from gps_sdr.config import GPS_C, OMEGA_EARTH
from gps_sdr.nativecore import native_evalcore
from gps_sdr.utils.geodesy import WGS84_A, WGS84_F


class FixResult(NamedTuple):
    rec_pos: np.ndarray     # [4]: (c*t0 in m, x, y, z)
    residual: float         # norm of the final update step
    range_est: np.ndarray   # [n] estimated geometric ranges, m
    meas_delay: np.ndarray  # [n] measured propagation distances, m
    n_iter: int
    clock_rate: float = 0.0  # total fractional receiver-clock rate
                             # error applied/solved (clock_rate_fix +
                             # the free unknown when clock_rate=True)
    cov: np.ndarray | None = None
    # [4, 4] parameter covariance (J' W J)^-1 in m^2 — exact when the
    # per-satellite sigmas are calibrated (they are: cophStd in
    # meters); feeds the track filter's measurement noise
    res_m: np.ndarray | None = None
    # [n] per-satellite measurement residuals at convergence
    # (range_est - c*t0 - c*(d_i - d_0)) in meters — the RAIM test
    # statistic's raw material


class FixBatch:
    """Struct-of-arrays result of solve_fix_batch.

    The evaluator consumes fixes in bulk (vectorized _fix_finish);
    materializing one FixResult namedtuple per epoch was a measurable
    slice of the serving host budget at merged-window epoch counts.
    Indexing (`batch[i]`) still yields a FixResult, slicing yields a
    FixBatch view, iteration yields FixResults — the per-epoch compat
    surface tests and fallback paths use.
    """

    __slots__ = ("pos", "residual", "range_est", "meas_delay",
                 "n_iter", "clock_rate", "cov", "res_m")

    def __init__(self, pos, residual, range_est, meas_delay, n_iter,
                 clock_rate, cov, res_m):
        self.pos = pos                  # [E, 4] (c*t0, x, y, z)
        self.residual = residual        # [E]
        self.range_est = range_est      # [E, n]
        self.meas_delay = meas_delay    # [E, n]
        self.n_iter = n_iter            # [E]
        self.clock_rate = clock_rate    # [E] total applied/solved
        self.cov = cov                  # [E, 4, 4] or None
        self.res_m = res_m              # [E, n]

    def __len__(self) -> int:
        return self.pos.shape[0]

    def __getitem__(self, i):
        if isinstance(i, slice):
            return FixBatch(self.pos[i], self.residual[i],
                            self.range_est[i], self.meas_delay[i],
                            self.n_iter[i], self.clock_rate[i],
                            None if self.cov is None else self.cov[i],
                            self.res_m[i])
        return FixResult(rec_pos=self.pos[i],
                         residual=float(self.residual[i]),
                         range_est=self.range_est[i],
                         meas_delay=self.meas_delay[i],
                         n_iter=int(self.n_iter[i]),
                         clock_rate=float(self.clock_rate[i]),
                         cov=None if self.cov is None else self.cov[i],
                         res_m=self.res_m[i])

    def __iter__(self):
        return (self[i] for i in range(len(self)))


def _sagnac(rec_pos: np.ndarray, range_est: np.ndarray) -> np.ndarray:
    """Satellite displacement due to earth rotation during signal flight:
    dp[:, i] = omega x r_rec * (range_i / c) (rotEarth, gpslib.py:1670-75)."""
    dt = range_est / GPS_C
    v = np.array([-rec_pos[2] * OMEGA_EARTH, rec_pos[1] * OMEGA_EARTH, 0.0])
    return np.outer(v, dt)


def solve_fix(sat_pos: np.ndarray, time_delay: np.ndarray,
              std_dev: np.ndarray | None = None,
              rec_pos0: np.ndarray | None = None,
              max_it: int = 15, max_residual: float = 1.0e-8,
              t0_guess: float = 0.07,
              height: float | None = None,
              height_dev: float = 1.0,
              clock_rate: bool = False,
              clock_rate_fix: float = 0.0) -> FixResult:
    """Weighted Gauss-Newton position fix.

    sat_pos: float64[3, n] satellite ECEF positions at transmit time;
    time_delay: float64[n] receive timestamps (s, receiver clock);
    std_dev: per-satellite sigma in meters (weights 1/sigma^2) or None;
    height: if given, adds the WGS84 height constraint row (3-sat mode,
    the reference's leastSquaresPos3).

    Receiver-clock rate (sample-clock skew): the delays are per-
    satellite ARRIVAL times of a common transmit epoch measured in
    receiver-clock seconds, so a skewed oscillator scales every delay
    DIFFERENCE by (1+y) — an elevation-correlated pseudorange
    distortion of y*c*(d_i-d_0), ~6 m at the reference's +-2 ppm TCXO
    envelope (README.md:204-217), that no per-epoch clock-bias unknown
    can absorb.  The reference instead demands a pre-calibrated
    SDR_FREQCORR.  `clock_rate_fix` applies a KNOWN fractional rate
    error y (e.g. the evaluator's filtered estimate) to the delays;
    `clock_rate=True` additionally solves the residual rate as a fifth
    unknown (needs n >= 5) — per-epoch it is noise-amplifying (the
    column correlates with height), so use it to FEED a cross-epoch
    filter, not for the reported position.

    Returns rec_pos = [c*t0, x, y, z] with t0 the propagation time of
    satellite 0; meas_delay = c*(d - d_0) + c*t0 are per-satellite
    propagation distances (skew-corrected); clock_rate the total
    fractional rate error applied + solved.
    """
    sat_pos = np.asarray(sat_pos, np.float64)
    n = sat_pos.shape[1]
    cdt = GPS_C * (np.asarray(time_delay, np.float64) - time_delay[0])
    cdt = cdt * (1.0 - clock_rate_fix)
    use_rate = clock_rate and n >= 5
    nu = 5 if use_rate else 4

    if use_rate:
        # stage the solve: the rate column is near-collinear with
        # height from a cold start (GN falls into the degenerate
        # all-delays-zero y=1 attractor), so converge the 4-unknown
        # fix first and refine with the rate free from there
        base = solve_fix(sat_pos, time_delay, std_dev=std_dev,
                         rec_pos0=rec_pos0, max_it=max_it,
                         max_residual=max_residual, t0_guess=t0_guess,
                         height=height, height_dev=height_dev,
                         clock_rate_fix=clock_rate_fix)
        rec_pos0 = base.rec_pos

    pos0 = np.zeros(4) if rec_pos0 is None else np.array(rec_pos0,
                                                         np.float64)
    pos = np.zeros(nu)
    pos[:4] = pos0[:4]
    pos[0] = GPS_C * t0_guess

    use_height = height is not None
    ab2 = 1.0 / (1.0 - WGS84_F) ** 2
    if use_height and pos[1] == 0 and pos[2] == 0:
        pos[1] = pos[2] = 3687000.0
    if use_height:
        r2 = (WGS84_A + height) ** 2 - pos[1] ** 2 - pos[2] ** 2
        pos[3] = (1.0 - WGS84_F) * np.sqrt(max(r2, 0.0))

    m = n + (1 if use_height else 0)
    if std_dev is None:
        w = np.ones(m)
    else:
        s = np.asarray(std_dev, np.float64)
        if use_height:
            s = np.append(s, height_dev)
        w = 1.0 / np.maximum(s, 1e-6) ** 2

    dp = np.zeros((3, n))
    residual = np.inf
    it = 0
    while it < max_it and residual > max_residual:
        diff = sat_pos - pos[1:4, None] - dp
        range_est = np.sqrt(np.sum(diff * diff, axis=0))
        dp = _sagnac(pos, range_est)

        cdt_eff = cdt * (1.0 - pos[4]) if use_rate else cdt
        fgn = np.empty(m)
        fgn[:n] = range_est - pos[0] - cdt_eff
        jac = np.zeros((m, nu))
        jac[:n, 0] = -1.0
        jac[:n, 1:4] = ((pos[1:4, None] - sat_pos) / range_est).T
        if use_rate:
            jac[:n, 4] = cdt
        if use_height:
            r_ell = np.sqrt(pos[1] ** 2 + pos[2] ** 2 + ab2 * pos[3] ** 2)
            fgn[n] = r_ell - (WGS84_A + height)
            jac[n, :4] = [0.0, pos[1] / r_ell, pos[2] / r_ell,
                          ab2 * pos[3] / r_ell]

        jtw = jac.T * w
        jtj = jtw @ jac
        try:
            # 4x4 normal equations: direct solve (LU) is ~20x cheaper
            # than the reference's pinv (SVD, gpslib.py:1728); pinv only
            # as the singular-geometry fallback
            delta = -np.linalg.solve(jtj, jtw @ fgn)
        except np.linalg.LinAlgError:
            delta = -np.linalg.pinv(jtj) @ (jtw @ fgn)
        pos = pos + delta
        if use_rate:
            # physical TCXOs stay within tens of ppm; the clamp removes
            # the degenerate y=1 attractor (all delays scaled to zero)
            # that a cold-started GN can otherwise fall into
            pos[4] = np.clip(pos[4], -2e-5, 2e-5)
        residual = float(np.linalg.norm(delta))
        it += 1

    cdt_eff = cdt * (1.0 - pos[4]) if use_rate else cdt
    y_total = clock_rate_fix + (float(pos[4]) if use_rate else 0.0)
    try:
        cov = np.linalg.inv(jtj)[:4, :4]
    except np.linalg.LinAlgError:
        cov = None
    return FixResult(rec_pos=pos[:4], residual=residual,
                     range_est=range_est,
                     meas_delay=cdt_eff + pos[0], n_iter=it,
                     clock_rate=y_total, cov=cov,
                     res_m=range_est - pos[0] - cdt_eff)


class VelocityResult(NamedTuple):
    vel: np.ndarray         # [3] receiver ECEF velocity, m/s
    clock_drift: float      # fractional receiver-clock rate error y
    residual: float         # RMS Doppler residual, Hz
    n_sat: int
    cov: np.ndarray | None = None
    # [3, 3] velocity covariance (m/s)^2: (A'A)^-1 scaled by the
    # residual variance (floored at a 0.1 Hz tracked-Doppler sigma)


def solve_velocity(sat_pos: np.ndarray, sat_vel: np.ndarray,
                   rec_pos: np.ndarray, freqs: np.ndarray,
                   l1_freq: float, std_dev: np.ndarray | None = None
                   ) -> VelocityResult | None:
    """Receiver velocity + clock drift from tracked carrier Dopplers.

    No reference equivalent: the reference tracks each carrier (FRQ in
    its per-second report) but never solves velocity.  The measurement
    model per satellite (the tracker's sign convention, see
    runtime/evaluator.py _update_clock_rate):

        f_i = -(L1/c) * (v_sat_i - v_rec) . los_i  -  y * L1

    with los_i the receiver->satellite unit vector and y the fractional
    receiver-clock rate error (one oscillator drives LO and ADC).
    Linear in (v_rec, y) — one weighted least-squares solve, no
    iteration.  Needs n >= 4.

    sat_pos/sat_vel: float64[3, n] ECEF at the epoch (velocity by
    central difference of the same ecef_coord the pseudoranges use, so
    the earth-rotation convention cancels); rec_pos: [3]; freqs: [n]
    tracked carrier offsets in Hz.
    """
    sat_pos = np.asarray(sat_pos, np.float64)
    n = sat_pos.shape[1]
    if n < 4:
        return None
    sat_vel = np.asarray(sat_vel, np.float64)
    rec = np.asarray(rec_pos, np.float64)
    d = sat_pos - rec[:, None]
    los = d / np.linalg.norm(d, axis=0)                  # [3, n]
    k = l1_freq / GPS_C
    a = np.empty((n, 4))
    a[:, :3] = k * los.T
    a[:, 3] = -l1_freq
    b = np.asarray(freqs, np.float64) + k * np.sum(sat_vel * los, axis=0)
    if std_dev is not None:
        w = 1.0 / np.maximum(np.asarray(std_dev, np.float64), 1e-6)
        a = a * w[:, None]
        b = b * w
    sol, *_ = np.linalg.lstsq(a, b, rcond=None)
    resid = float(np.sqrt(np.mean((a @ sol - b) ** 2)))
    try:
        cov_u = np.linalg.inv(a.T @ a)
        var = max(resid * resid * n / max(n - 4, 1), 0.1 ** 2)
        cov = cov_u[:3, :3] * var
    except np.linalg.LinAlgError:
        cov = None
    return VelocityResult(vel=sol[:3], clock_drift=float(sol[3]),
                          residual=resid, n_sat=n, cov=cov)


def solve_fix_batch(sat_pos: np.ndarray, time_delay: np.ndarray,
                    std_dev: np.ndarray | None = None,
                    rec_pos0: np.ndarray | None = None,
                    max_it: int = 15, max_residual: float = 1.0e-8,
                    t0_guess: float = 0.07,
                    height: float | None = None,
                    height_dev: float = 1.0,
                    clock_rate: bool = False,
                    clock_rate_fix=0.0) -> "FixBatch":
    """solve_fix over a batch of E epochs that share the satellite count.

    sat_pos float64[E, 3, n]; time_delay float64[E, n]; std_dev
    float64[E, n] or None; rec_pos0 one shared warm start [4] or
    per-epoch [E, 4] (GN converges to |delta| < max_residual, so the
    optimum is start-independent for any converging epoch);
    clock_rate_fix a scalar or per-epoch [E] (the serving path stacks
    MANY independent streams' epochs into one call, each with its own
    filtered clock-rate estimate).  All E normal-equation solves run as
    one stacked [E, 4, 4] np.linalg.solve per iteration — the
    per-second fix cadence (32 epochs/s) in ~3 batched iterations
    instead of 32 Python GN loops.  Returns a FixBatch (indexable to
    per-epoch FixResults).
    """
    sat_pos = np.asarray(sat_pos, np.float64)
    E, _, n = sat_pos.shape
    td = np.asarray(time_delay, np.float64)
    crf = np.asarray(clock_rate_fix, np.float64)
    if crf.ndim == 0:
        crf = np.full(E, float(crf))
    use_rate = clock_rate and n >= 5
    if not use_rate:
        core = native_evalcore()
        if core:
            m = n + (1 if height is not None else 0)
            if std_dev is None:
                w = np.ones((E, m))
            else:
                s = np.asarray(std_dev, np.float64)
                if height is not None:
                    s = np.concatenate(
                        [s, np.full((E, 1), height_dev)], axis=1)
                w = 1.0 / np.maximum(s, 1e-6) ** 2
            rp0 = (None if rec_pos0 is None else np.broadcast_to(
                np.asarray(rec_pos0, np.float64)[..., :4], (E, 4)))
            res = core.fix_batch(sat_pos, td, w, rp0, crf, max_it,
                                 max_residual, t0_guess, height)
            if res is not None:
                pos, residual, rng, meas, n_iter, covs, res_m = res
                return FixBatch(pos=pos, residual=residual,
                                range_est=rng, meas_delay=meas,
                                n_iter=n_iter, clock_rate=crf,
                                cov=covs, res_m=res_m)
            # a singular epoch: fall through to the numpy path, whose
            # batch np.linalg.solve raises for the caller's fallback
    cdt = GPS_C * (td - td[:, :1]) * (1.0 - crf[:, None])
    nu = 5 if use_rate else 4

    pos = np.zeros((E, nu))
    if use_rate:
        # staged solve (see solve_fix): 4-unknown convergence first
        base = solve_fix_batch(sat_pos, time_delay, std_dev=std_dev,
                               rec_pos0=rec_pos0, max_it=max_it,
                               max_residual=max_residual,
                               t0_guess=t0_guess, height=height,
                               height_dev=height_dev,
                               clock_rate_fix=clock_rate_fix)
        pos[:, :4] = base.pos
    elif rec_pos0 is not None:
        pos[:, :4] = np.asarray(rec_pos0, np.float64)[..., :4]
    pos[:, 0] = GPS_C * t0_guess

    use_height = height is not None
    ab2 = 1.0 / (1.0 - WGS84_F) ** 2
    if use_height:
        z0 = (pos[:, 1] == 0) & (pos[:, 2] == 0)
        pos[z0, 1] = pos[z0, 2] = 3687000.0
        r2 = (WGS84_A + height) ** 2 - pos[:, 1] ** 2 - pos[:, 2] ** 2
        pos[:, 3] = (1.0 - WGS84_F) * np.sqrt(np.maximum(r2, 0.0))

    m = n + (1 if use_height else 0)
    if std_dev is None:
        w = np.ones((E, m))
    else:
        s = np.asarray(std_dev, np.float64)
        if use_height:
            s = np.concatenate([s, np.full((E, 1), height_dev)], axis=1)
        w = 1.0 / np.maximum(s, 1e-6) ** 2

    dp = np.zeros((E, 3, n))
    residual = np.full(E, np.inf)
    n_iter = np.zeros(E, np.int64)
    # GN iterations run on the ACTIVE epoch subset only: the Sagnac
    # re-linearization makes |delta| plateau ~1e-7, so tight gates leave
    # a few stragglers iterating to max_it — without compaction every
    # converged epoch in the stack pays for them (the cross-stream
    # serving batch stacks hundreds of epochs into one call)
    ai = np.arange(E)
    for _ in range(max_it):
        ai = ai[residual[ai] > max_residual]
        if ai.size == 0:
            break
        na = ai.size
        sp_a, pos_a, dp_a = sat_pos[ai], pos[ai], dp[ai]
        cdt_a, w_a = cdt[ai], w[ai]
        diff = sp_a - pos_a[:, 1:4, None] - dp_a
        range_a = np.sqrt(np.sum(diff * diff, axis=1))
        omega_v = OMEGA_EARTH * np.stack(
            [-pos_a[:, 2], pos_a[:, 1], np.zeros(na)], axis=1)
        dp[ai] = omega_v[:, :, None] * (range_a / GPS_C)[:, None, :]

        cdt_eff = cdt_a * (1.0 - pos_a[:, 4:5]) if use_rate else cdt_a
        fgn = np.empty((na, m))
        fgn[:, :n] = range_a - pos_a[:, :1] - cdt_eff
        jac = np.zeros((na, m, nu))
        jac[:, :n, 0] = -1.0
        jac[:, :n, 1:4] = np.transpose(
            (pos_a[:, 1:4, None] - sp_a) / range_a[:, None, :],
            (0, 2, 1))
        if use_rate:
            jac[:, :n, 4] = cdt_a
        if use_height:
            r_ell = np.sqrt(pos_a[:, 1] ** 2 + pos_a[:, 2] ** 2
                            + ab2 * pos_a[:, 3] ** 2)
            fgn[:, n] = r_ell - (WGS84_A + height)
            jac[:, n, 0] = 0.0
            jac[:, n, 1] = pos_a[:, 1] / r_ell
            jac[:, n, 2] = pos_a[:, 2] / r_ell
            jac[:, n, 3] = ab2 * pos_a[:, 3] / r_ell

        jtw = np.transpose(jac, (0, 2, 1)) * w_a[:, None, :]
        jtj = jtw @ jac
        rhs = (jtw @ fgn[:, :, None])[:, :, 0]
        delta = -np.linalg.solve(jtj, rhs[:, :, None])[:, :, 0]
        pos_a = pos_a + delta
        if use_rate:
            pos_a[:, 4] = np.clip(pos_a[:, 4], -2e-5, 2e-5)
        pos[ai] = pos_a
        residual[ai] = np.linalg.norm(delta, axis=1)
        n_iter[ai] += 1

    # final full-batch recompute at the converged positions: the Sagnac
    # fixed point restarts deterministically from dp=0 (converges in
    # ~2 passes: |omega x r| * range/c corrections are ~1e-7 relative),
    # so the reported ranges/covariances are functions of the FINAL
    # position only — independent of the epoch's iteration history and
    # of whatever else shares the stacked batch (and never one
    # iteration stale, which the in-loop values were for epochs that
    # updated on the last pass)
    omega_v = OMEGA_EARTH * np.stack(
        [-pos[:, 2], pos[:, 1], np.zeros(E)], axis=1)
    dp = np.zeros((E, 3, n))
    for _ in range(3):
        diff = sat_pos - pos[:, 1:4, None] - dp
        range_est = np.sqrt(np.sum(diff * diff, axis=1))
        dp = omega_v[:, :, None] * (range_est / GPS_C)[:, None, :]
    diff = sat_pos - pos[:, 1:4, None] - dp
    range_est = np.sqrt(np.sum(diff * diff, axis=1))
    jac = np.zeros((E, m, nu))
    jac[:, :n, 0] = -1.0
    jac[:, :n, 1:4] = np.transpose(
        (pos[:, 1:4, None] - sat_pos) / range_est[:, None, :], (0, 2, 1))
    if use_rate:
        jac[:, :n, 4] = cdt
    if use_height:
        r_ell = np.sqrt(pos[:, 1] ** 2 + pos[:, 2] ** 2
                        + ab2 * pos[:, 3] ** 2)
        jac[:, n, 1] = pos[:, 1] / r_ell
        jac[:, n, 2] = pos[:, 2] / r_ell
        jac[:, n, 3] = ab2 * pos[:, 3] / r_ell
    jtw = np.transpose(jac, (0, 2, 1)) * w[:, None, :]
    jtj = jtw @ jac

    cdt_eff = cdt * (1.0 - pos[:, 4:5]) if use_rate else cdt
    try:
        covs = np.linalg.inv(jtj)[:, :4, :4]
    except np.linalg.LinAlgError:
        covs = None
    return FixBatch(
        pos=pos[:, :4], residual=residual, range_est=range_est,
        meas_delay=cdt_eff + pos[:, :1], n_iter=n_iter,
        clock_rate=crf + (pos[:, 4] if use_rate else 0.0),
        cov=covs, res_m=range_est - pos[:, :1] - cdt_eff)
