"""ctypes binding for the native host evaluator core (csrc/evalcore.cpp).

Build with `make -C csrc` (produces gps_sdr/libgsdreval.so).  The
library implements the four hottest pure-math stages of the host
evaluator path — batched satellite ECEF propagation, the batched
Gauss-Newton fix solver, the per-segment code-phase sigma/slope, and
the code-phase overflow unwrap — as straight-line C++ (csrc/navscan.cpp
pattern: on the 1-core deployment host, per-call overhead of many small
numpy ops dominated the serving host stages).

Python remains the semantic source of truth: every caller keeps its
numpy path and `GSDR_EVALCORE=0` forces it (equivalence tests in
tests/test_native.py pin native == Python).  Loading never compiles
(see models/_navscan.py): run `make -C csrc`, or set
GSDR_EVALCORE_BUILD=1 to opt in to an import-time build.

Arguments are passed as raw pointers (c_void_p + ndarray.ctypes.data):
np.ctypeslib ndpointer validation measured 2x the per-call overhead,
and these calls run thousands of times per serving second.  Every
array is made C-contiguous with the right dtype HERE — keep it that
way; the C side trusts the layout.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "libgsdreval.so")

from gps_sdr.nativecore import load_native_lib  # noqa: E402

_lib = load_native_lib(_LIB_PATH, "GSDR_EVALCORE_BUILD")

_p = ctypes.c_void_p
_i32 = ctypes.c_int32
_i64 = ctypes.c_int64
_f64 = ctypes.c_double

_lib.gsdr_ecef.argtypes = [_p, _p, _p, _i64, _i32, _p, _p, _p, _p]
_lib.gsdr_ecef.restype = None

_lib.gsdr_fix_batch.argtypes = [
    _p, _p, _p, _p, _p, _i64, _i64, _i32, _f64, _f64, _i32, _f64,
    _f64, _p, _p, _p, _p, _p, _p, _p]
_lib.gsdr_fix_batch.restype = _i32

_lib.gsdr_sigma_slope.argtypes = [
    _p, _p, _i64, _i64, _i64, _f64, _f64, _p, _p, _i64, _p, _p]
_lib.gsdr_sigma_slope.restype = None

_lib.gsdr_unwrap.argtypes = [_p, _p, _i64, _f64, _f64, _p, _i64]
_lib.gsdr_unwrap.restype = _i64


def _c(a, dtype):
    return np.ascontiguousarray(a, dtype)


def ecef_batch(tow: np.ndarray, dt: np.ndarray, eph_mat: np.ndarray,
               rel_corr: bool = True):
    """Batched ecef_coord over per-row ephemeris rows.

    eph_mat: float64[n, 26] in EPHEM_KEYS column order
    (models/pseudorange.py:36).  Returns (x, y, z, dtsv)."""
    tow = _c(tow, np.float64)
    n = tow.shape[0]
    dt = _c(np.broadcast_to(dt, (n,)), np.float64)
    eph_mat = _c(eph_mat, np.float64)
    assert eph_mat.shape == (n, 26)
    x = np.empty(n, np.float64)
    y = np.empty(n, np.float64)
    z = np.empty(n, np.float64)
    dtsv = np.empty(n, np.float64)
    _lib.gsdr_ecef(tow.ctypes.data, dt.ctypes.data, eph_mat.ctypes.data,
                   n, int(rel_corr), x.ctypes.data, y.ctypes.data,
                   z.ctypes.data, dtsv.ctypes.data)
    return x, y, z, dtsv


def fix_batch(sat_pos: np.ndarray, delay: np.ndarray, w: np.ndarray,
              rec_pos0: np.ndarray | None, crf: np.ndarray,
              max_it: int, max_residual: float, t0_guess: float,
              height: float | None):
    """Batched 4-unknown GN solve (ops/pvt.py solve_fix_batch port).

    w: float64[E, m] prebuilt weights (height row included when height
    is not None).  Returns (pos[E,4], residual[E], range_est[E,n],
    meas_delay[E,n], n_iter[E], cov[E,4,4] | None, res_m[E,n]) or
    None when the native solve hit a singular epoch (caller must run
    the Python path, which reproduces numpy's batch-wide LinAlgError
    handling)."""
    sat_pos = _c(sat_pos, np.float64)
    E, _, n = sat_pos.shape
    delay = _c(delay, np.float64)
    w = _c(w, np.float64)
    crf = _c(crf, np.float64)
    rp = None if rec_pos0 is None else _c(rec_pos0, np.float64)
    pos = np.empty((E, 4), np.float64)
    residual = np.empty(E, np.float64)
    rng = np.empty((E, n), np.float64)
    meas = np.empty((E, n), np.float64)
    n_iter = np.empty(E, np.int64)
    cov = np.empty((E, 16), np.float64)
    res_m = np.empty((E, n), np.float64)
    rc = _lib.gsdr_fix_batch(
        sat_pos.ctypes.data, delay.ctypes.data, w.ctypes.data,
        None if rp is None else rp.ctypes.data, crf.ctypes.data,
        E, n, int(max_it), float(max_residual), float(t0_guess),
        int(height is not None),
        0.0 if height is None else float(height), 0.0,
        pos.ctypes.data, residual.ctypes.data, rng.ctypes.data,
        meas.ctypes.data, n_iter.ctypes.data, cov.ctypes.data,
        res_m.ctypes.data)
    if rc == -1:
        return None
    covs = None if rc == -2 else cov.reshape(E, 4, 4)
    return pos, residual, rng, meas, n_iter, covs, res_m


def sigma_slope(snos: np.ndarray, cps: np.ndarray, no_sec: int,
                n_cyc: int, cap: float, m_per_smp: float,
                hist: list) -> tuple[np.ndarray, np.ndarray]:
    """Per-segment sigma/slope (models/pseudorange.py _sigma_and_slope
    port).  `hist` is the engine's slope_hist list — updated in place
    exactly as the Python walk would."""
    snos = _c(snos, np.int64)
    cps = _c(cps, np.float64)
    n = snos.shape[0]
    max_hist = 1024 // n_cyc
    h = np.zeros(max_hist + 1, np.float64)
    hl = np.array([len(hist)], np.int64)
    h[:len(hist)] = hist
    sig = np.empty(n, np.float64)
    slp = np.empty(n, np.float64)
    _lib.gsdr_sigma_slope(snos.ctypes.data, cps.ctypes.data, n, no_sec,
                          n_cyc, cap, m_per_smp, h.ctypes.data,
                          hl.ctypes.data, max_hist, sig.ctypes.data,
                          slp.ctypes.data)
    hist[:] = h[:int(hl[0])].tolist()
    return sig, slp


def unwrap(snos: np.ndarray, cps: np.ndarray, cs: float,
           diff_tol: float) -> tuple[np.ndarray, np.ndarray]:
    """Overflow unwrap (runtime/evaluator.py unwrap_code_phases core).
    Returns (corrected copy of cps, indices i of flagged steps between
    entries i and i+1)."""
    snos = _c(snos, np.int64)
    out = np.array(cps, np.float64)           # corrected in place
    n = snos.shape[0]
    err = np.empty(n, np.int64)
    k = _lib.gsdr_unwrap(snos.ctypes.data, out.ctypes.data, n,
                         float(cs), float(diff_tol), err.ctypes.data, n)
    return out, err[:int(k)]
