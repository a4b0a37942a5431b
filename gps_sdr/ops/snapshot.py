"""Coarse-time ("snapshot") positioning: a fix from one IQ block.

No reference equivalent — beyond-reference capability.  The reference
needs ~30 s of decoded navigation data before its first fix: code
phases only become pseudoranges once a subframe's (TOW, ST) reference
has been decoded and parity-checked (src/gpslib.py:897-1039,
src/gpseval.py:181-232).  Snapshot mode instead resolves the 1 ms code
ambiguity from a coarse prior (position to ~100 km, time to ~1 min —
e.g. a previous fix + cached ephemeris/almanac) using van Diggelen's
integer-rollover method, and solves FIVE unknowns — position, common
clock bias, and the coarse-time error — from the sub-millisecond code
phases of a single ~32 ms block.  No bits are decoded at all.

Measurement model.  Acquisition reports the sample offset d of each
satellite's code-period start within the block (sub-sample peak fit,
ops/acquisition.py).  Code periods start at integer milliseconds of SV
clock time, so with tau the propagation delay and dtsv the SV clock
offset, d/code_samples == (tau - dtsv)*1e3 - t_rx*1e3 (mod 1); the
common receive-time term is absorbed by the clock-bias unknown.  The
reconstructed pseudorange for resolved integer N is

    pr_i [ms] = N_i + d_i/code_samples
    model_i   = range_i(x, t + dt)/c - dtsv_i + b

The coarse-time unknown dt moves every satellite along its orbit;
its Jacobian column is the per-satellite range rate (-800..+800 m/s),
which is what separates dt from the common bias b.  Needs >= 5
satellites (>= 4 with the WGS84 height constraint, as in ops/pvt.py).

Host float64, like ops/pvt.py: a handful of 5x5 normal equations.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from gps_sdr.config import GPS_C, OMEGA_EARTH
from gps_sdr.models import orbits
from gps_sdr.models.pseudorange import EPHEM_KEYS
from gps_sdr.utils.geodesy import WGS84_A, WGS84_F

MS = 1.0e-3


class SnapshotResult(NamedTuple):
    rec_pos: np.ndarray     # [3] ECEF, m
    clock_bias_m: float     # common bias b, meters (includes rx-time frac)
    dt_s: float             # coarse-time correction, s
    t_gps: float            # corrected GPS seconds-of-week of the block
    residual_m: float       # RMS post-fit pseudorange residual
    n_iter: int
    n_sat: int
    ms_int: np.ndarray      # [n] resolved millisecond integers
    converged: bool = True  # Gauss-Newton step dropped below max_residual


def _stack_ephs(ephs: list[dict]) -> dict:
    """Ephemeris-of-arrays so one ecef_coord call evaluates all sats."""
    return {k: np.array([e[k] for e in ephs], np.float64)
            for k in EPHEM_KEYS}


def _sat_states(eph_b: dict, t_tx: np.ndarray, tau: np.ndarray):
    """Positions (Sagnac-rotated into the receive-time ECEF frame),
    clock offsets, and velocities of all sats at transmit times t_tx
    [GPS seconds of week]."""
    x, y, z, dtsv = orbits.ecef_coord(1.0, eph_b, dt_from_tow=t_tx)
    ang = OMEGA_EARTH * tau
    c, s = np.cos(ang), np.sin(ang)
    pos = np.stack([c * x + s * y, -s * x + c * y, z])        # [3, n]
    h = 0.05
    xa, ya, za, _ = orbits.ecef_coord(1.0, eph_b, dt_from_tow=t_tx - h)
    xb, yb, zb, _ = orbits.ecef_coord(1.0, eph_b, dt_from_tow=t_tx + h)
    vel = np.stack([(xb - xa), (yb - ya), (zb - za)]) / (2 * h)
    return pos, dtsv, vel


def resolve_ms_integers(eph_b: dict, frac_ms: np.ndarray, t_gps: float,
                        rec_pos: np.ndarray) -> np.ndarray:
    """Van Diggelen integer rollover resolution: anchor the nearest
    satellite's integer to the predicted range, estimate the common
    bias from it, then round every other satellite's integer relative
    to that bias.  Valid while the prior is within ~150 km / ~1 min."""
    n = len(frac_ms)
    tau = np.full(n, 0.07)
    for _ in range(2):
        pos, dtsv, _ = _sat_states(eph_b, t_gps - tau, tau)
        rng = np.linalg.norm(pos - rec_pos[:, None], axis=0)
        tau = rng / GPS_C
    pred_ms = (tau - dtsv) / MS                              # [n]
    j = int(np.argmin(rng))                                  # highest elev
    n_j = np.rint(pred_ms[j] - frac_ms[j])
    bias = (n_j + frac_ms[j]) - pred_ms[j]
    return np.rint(pred_ms + bias - frac_ms).astype(np.int64)


def solve_snapshot(ephs: list[dict], frac_ms: np.ndarray, t_gps: float,
                   rec_pos0: np.ndarray,
                   std_m: np.ndarray | None = None,
                   height: float | None = None,
                   height_dev: float = 1.0,
                   max_it: int = 25,
                   max_residual: float = 1.0e-7) -> SnapshotResult | None:
    """Coarse-time Gauss-Newton snapshot fix.

    ephs: per-satellite ephemeris dicts; frac_ms: float64[n] fractional
    code phases in milliseconds (acquisition code_phase/code_samples);
    t_gps: coarse GPS seconds-of-week of the block start; rec_pos0 [3]:
    coarse ECEF prior.  Returns None when underdetermined.

    Validity: the millisecond-integer resolution assumes the prior is
    within ~150 km / ~1 min of truth; a worse prior can mis-resolve the
    integers and converge to a confidently wrong position.  Callers
    must gate on the returned residual_m (a mis-resolved integer leaves
    hundreds of meters of post-fit residual) and on `converged`.
    """
    frac_ms = np.asarray(frac_ms, np.float64) % 1.0
    n = len(frac_ms)
    nu = 5
    use_height = height is not None
    if n < nu - (1 if use_height else 0):
        return None
    eph_b = _stack_ephs(ephs)

    m = n + (1 if use_height else 0)
    if std_m is None:
        w = np.ones(m)
    else:
        s = np.asarray(std_m, np.float64)
        if use_height:
            s = np.append(s, height_dev)
        w = 1.0 / np.maximum(s, 1e-6) ** 2
    ab2 = 1.0 / (1.0 - WGS84_F) ** 2

    # unknowns u = [x, y, z, b_m, dt_s]
    u = np.zeros(nu)
    u[:3] = np.asarray(rec_pos0, np.float64)
    ints = resolve_ms_integers(eph_b, frac_ms, t_gps, u[:3])
    pr_s = (ints + frac_ms) * MS                             # [n]

    residual = np.inf
    it = 0
    reresolved = False
    dtsv = np.zeros(n)
    while it < max_it and residual > max_residual:
        # pr = tau - dtsv + b/c  =>  tau = pr + dtsv - b/c; dtsv from
        # the previous iteration (it changes by < 1e-9 s/iter)
        tau = pr_s + dtsv - u[3] / GPS_C
        t_tx = t_gps + u[4] - tau
        pos, dtsv, vel = _sat_states(eph_b, t_tx, tau)
        diff = pos - u[:3, None]
        rng = np.linalg.norm(diff, axis=0)
        los = -diff / rng                                    # d rng / d x

        fgn = np.empty(m)
        fgn[:n] = rng - GPS_C * (pr_s + dtsv) + u[3]
        jac = np.zeros((m, nu))
        jac[:n, :3] = los.T
        jac[:n, 3] = 1.0
        jac[:n, 4] = np.sum(-los * vel, axis=0)              # range rate
        if use_height:
            r_ell = np.sqrt(u[0] ** 2 + u[1] ** 2 + ab2 * u[2] ** 2)
            fgn[n] = r_ell - (WGS84_A + height)
            jac[n, :3] = [u[0] / r_ell, u[1] / r_ell, ab2 * u[2] / r_ell]

        jtw = jac.T * w
        jtj = jtw @ jac
        try:
            delta = -np.linalg.solve(jtj, jtw @ fgn)
        except np.linalg.LinAlgError:
            delta = -np.linalg.pinv(jtj) @ (jtw @ fgn)
        u = u + delta
        residual = float(np.linalg.norm(delta))
        it += 1
        if not reresolved and residual < 1.0:
            # the prior may have mis-rounded an integer near a 0.5 ms
            # boundary; re-resolve once from the converged state
            new_ints = resolve_ms_integers(
                eph_b, frac_ms, t_gps + u[4], u[:3])
            if (new_ints != ints).any():
                ints = new_ints
                pr_s = (ints + frac_ms) * MS
                residual = np.inf
            reresolved = True

    # evaluate the model once more at the FINAL u: fgn above was formed
    # at the previous iterate, so reporting it would understate (or
    # overstate) the misfit of the state actually returned
    tau = pr_s + dtsv - u[3] / GPS_C
    pos, dtsv, _ = _sat_states(eph_b, t_gps + u[4] - tau, tau)
    rng = np.linalg.norm(pos - u[:3, None], axis=0)
    res_m = rng - GPS_C * (pr_s + dtsv) + u[3]
    return SnapshotResult(
        rec_pos=u[:3], clock_bias_m=float(u[3]), dt_s=float(u[4]),
        t_gps=t_gps + float(u[4]),
        residual_m=float(np.sqrt(np.mean(res_m ** 2))),
        n_iter=it, n_sat=n, ms_int=ints,
        converged=bool(residual <= max_residual))


def snapshot_fix(cfg, block, code_fft_table, ephs_by_prn: dict,
                 t_gps: float, rec_pos0: np.ndarray,
                 prns=None, dopplers=None, min_corr: float | None = None,
                 height: float | None = None) -> SnapshotResult | None:
    """One-block acquisition -> snapshot fix.

    Runs the full-grid acquisition (ops/acquisition.py) on `block`,
    keeps found PRNs that have an ephemeris in `ephs_by_prn`, converts
    the sub-sample code phases to fractional milliseconds, and solves.
    """
    import jax.numpy as jnp

    from gps_sdr.ops.acquisition import acquire
    from gps_sdr.ops.tracking import to_f32_pairs

    prns = list(cfg.prns if prns is None else prns)
    if dopplers is None:
        dopplers = cfg.doppler_bins
    if isinstance(block, np.ndarray) and block.dtype != np.float32:
        block = to_f32_pairs(block)
    res = acquire(cfg, jnp.asarray(block),
                  jnp.asarray(np.asarray(dopplers), np.float32),
                  jnp.asarray(to_f32_pairs(
                      code_fft_table[np.asarray(prns)])))
    found = np.asarray(res.found) > 0.5
    norm = np.asarray(res.norm_max)
    cp = np.asarray(res.code_phase, np.float64)
    thr = cfg.corr_min if min_corr is None else min_corr
    ephs, frac, sig = [], [], []
    for i, prn in enumerate(prns):
        if found[i] and norm[i] >= thr and prn in ephs_by_prn:
            ephs.append(ephs_by_prn[prn])
            frac.append(cp[i] / cfg.code_samples)
            # peak-fit sigma shrinks with correlation strength; an
            # empirical ~0.25-sample floor weights strong sats evenly
            sig.append(max(0.25, 8.0 / norm[i])
                       * GPS_C / (cfg.code_samples * 1000.0))
    if len(ephs) < (4 if height is not None else 5):
        return None
    return solve_snapshot(ephs, np.asarray(frac), t_gps,
                          np.asarray(rec_pos0, np.float64),
                          std_m=np.asarray(sig), height=height)
