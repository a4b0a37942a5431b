// Native host evaluator core: the hot f64 arithmetic of the
// pseudorange/PVT host path as straight-line C++.
//
// The evaluator's cost is dominated by per-call overhead of many small
// numpy ops (consume+evaluate are the serving knee once the device
// dispatch is fused).  This library moves the four hottest
// pure-math stages native, following the csrc/navscan.cpp pattern:
// Python keeps the control flow and remains the single source of truth
// for semantics (GSDR_EVALCORE=0 switches back; equivalence tests pin
// native == Python).
//
// Behavior surfaces mirrored from this repo's own modules (reference
// call sites cited there):
//   gsdr_ecef        <- gps_sdr/models/orbits.py ecef_coord
//                       (reference SatPos.ecefCoord, gpslib.py:589-642)
//   gsdr_fix_batch   <- gps_sdr/ops/pvt.py solve_fix_batch
//                       (reference leastSquaresPos, gpslib.py:1641-1791)
//   gsdr_sigma_slope <- gps_sdr/models/pseudorange.py
//                       _sigma_and_slope (reference getStdDev,
//                       gpslib.py:864-883)
//   gsdr_unwrap      <- gps_sdr/runtime/evaluator.py
//                       unwrap_code_phases (reference cpOflCorrection,
//                       gpseval.py:377-417)
//
// All arrays are C-contiguous f64/i64 unless noted.  Single-threaded
// by design: serving runs one evaluator thread per process.

#include <cmath>
#include <cstdint>
#include <cstring>

// glibc sincos (one transcendental call per sin/cos pair; the Kepler
// loop is sincos-bound)
extern "C" void sincos(double, double*, double*);

namespace {

constexpr double kMuEarth = 3.986005e14;        // WGS84 mu, m^3/s^2
constexpr double kFRel = -4.442807633e-10;      // s/sqrt(m)
constexpr double kOmegaEarth = 7.292115147e-5;  // rad/s (config.py:24)
constexpr double kWeekSec = 604800.0;
constexpr double kGpsC = 2.99792458e8;
constexpr double kWgsA = 6378137.0;
constexpr double kWgsF = 1.0 / 298.257223563;

// EPHEM_KEYS column order (models/pseudorange.py:36) — pinned by the
// native-vs-Python equivalence test in tests/test_native.py
enum EphCol {
  kWeekNum = 0, kTgd = 1, kToc = 2, kAf2 = 3, kAf1 = 4, kAf0 = 5,
  kIodc = 6, kSatAcc = 7, kCrs = 8, kDeltaN = 9, kM0 = 10, kCuc = 11,
  kE = 12, kCus = 13, kSqrtA = 14, kToe = 15, kIode2 = 16, kCic = 17,
  kOmegaBig = 18, kCis = 19, kI0 = 20, kCrc = 21, kOmegaSmall = 22,
  kOmegaDot = 23, kIdot = 24, kIode3 = 25, kNEphCols = 26
};

inline double cross_time(double t) {
  // wrap into +-half a week (orbits.py cross_time); C++ fmod keeps the
  // sign of the dividend, so add-then-fmod needs the negative branch
  double half = kWeekSec / 2.0;
  double m = std::fmod(t + half, kWeekSec);
  if (m < 0) m += kWeekSec;
  return m - half;
}

// Solve A x = b for nu<=5 unknowns, Gaussian elimination with partial
// pivoting.  Returns false on an exactly-zero pivot (numpy/LAPACK's
// singularity condition for dgesv).
bool solve_small(double* a, double* b, int nu) {
  for (int c = 0; c < nu; ++c) {
    int piv = c;
    double best = std::fabs(a[c * nu + c]);
    for (int r = c + 1; r < nu; ++r) {
      double v = std::fabs(a[r * nu + c]);
      if (v > best) { best = v; piv = r; }
    }
    if (best == 0.0) return false;
    if (piv != c) {
      for (int j = 0; j < nu; ++j)
        std::swap(a[c * nu + j], a[piv * nu + j]);
      std::swap(b[c], b[piv]);
    }
    double inv = 1.0 / a[c * nu + c];
    for (int r = c + 1; r < nu; ++r) {
      double f = a[r * nu + c] * inv;
      if (f == 0.0) continue;
      for (int j = c; j < nu; ++j) a[r * nu + j] -= f * a[c * nu + j];
      b[r] -= f * b[c];
    }
  }
  for (int c = nu - 1; c >= 0; --c) {
    double s = b[c];
    for (int j = c + 1; j < nu; ++j) s -= a[c * nu + j] * b[j];
    b[c] = s / a[c * nu + c];
  }
  return true;
}

// Invert the nu x nu matrix `a` into `out` (Gauss-Jordan, partial
// pivoting).  Returns false on a zero pivot.
bool inv_small(const double* a_in, double* out, int nu) {
  double a[25];
  std::memcpy(a, a_in, sizeof(double) * nu * nu);
  for (int i = 0; i < nu * nu; ++i) out[i] = 0.0;
  for (int i = 0; i < nu; ++i) out[i * nu + i] = 1.0;
  for (int c = 0; c < nu; ++c) {
    int piv = c;
    double best = std::fabs(a[c * nu + c]);
    for (int r = c + 1; r < nu; ++r) {
      double v = std::fabs(a[r * nu + c]);
      if (v > best) { best = v; piv = r; }
    }
    if (best == 0.0) return false;
    if (piv != c) {
      for (int j = 0; j < nu; ++j) {
        std::swap(a[c * nu + j], a[piv * nu + j]);
        std::swap(out[c * nu + j], out[piv * nu + j]);
      }
    }
    double inv = 1.0 / a[c * nu + c];
    for (int j = 0; j < nu; ++j) {
      a[c * nu + j] *= inv;
      out[c * nu + j] *= inv;
    }
    for (int r = 0; r < nu; ++r) {
      if (r == c) continue;
      double f = a[r * nu + c];
      if (f == 0.0) continue;
      for (int j = 0; j < nu; ++j) {
        a[r * nu + j] -= f * a[c * nu + j];
        out[r * nu + j] -= f * out[c * nu + j];
      }
    }
  }
  return true;
}

}  // namespace

// -- satellite ECEF propagation ----------------------------------------------
//
// tow[n], dt_from_tow[n]: per-row transmit epoch; eph[n*26] row-major
// in EPHEM_KEYS order.  Outputs x, y, z, dtsv (each [n]).  rel_corr
// selects the two-pass relativistic correction (orbits.py:72-80).
extern "C" void gsdr_ecef(const double* tow, const double* dt,
                          const double* eph, int64_t n, int32_t rel_corr,
                          double* x, double* y, double* z, double* dtsv) {
  for (int64_t i = 0; i < n; ++i) {
    const double* ep = eph + i * kNEphCols;
    double t_sv = (tow[i] - 1.0) * 6.0 + dt[i];
    double e = ep[kE];
    double sqrt_a = ep[kSqrtA];
    double dtr = 0.0;
    double dts = 0.0, tk = 0.0, Ek = 0.0;
    int passes = rel_corr ? 2 : 1;
    for (int it = 0; it < passes; ++it) {
      double dtoc = cross_time(t_sv - ep[kToc]);
      dts = ep[kAf0] + ep[kAf1] * dtoc + ep[kAf2] * dtoc * dtoc
            + dtr - ep[kTgd];
      double gps_t = t_sv - dts;
      tk = cross_time(gps_t - ep[kToe]);
      double n0 = std::sqrt(kMuEarth) / (sqrt_a * sqrt_a * sqrt_a);
      double Mk = ep[kM0] + (n0 + ep[kDeltaN]) * tk;
      Ek = Mk;
      for (int k = 0; k < 10; ++k) {
        double sE, cE;
        sincos(Ek, &sE, &cE);
        double step = (Ek - e * sE - Mk) / (1.0 - e * cE);
        Ek -= step;
        // converged to the f64 fixed point: further Newton steps are
        // identity within rounding (orbits.py runs all 10; the results
        // agree below the 1e-6 m equivalence gate)
        if (std::fabs(step) < 1e-14) break;
      }
      if (rel_corr && it == 0) dtr = kFRel * e * sqrt_a * std::sin(Ek);
    }
    double sEk, cEk;
    sincos(Ek, &sEk, &cEk);
    double nu_k = std::atan2(std::sqrt(1.0 - e * e) * sEk, cEk - e);
    double phi_k = nu_k + ep[kOmegaSmall];
    double s2p, c2p;
    sincos(2.0 * phi_k, &s2p, &c2p);
    double du = ep[kCus] * s2p + ep[kCuc] * c2p;
    double dr = ep[kCrc] * c2p + ep[kCrs] * s2p;
    double di = ep[kCic] * c2p + ep[kCis] * s2p;
    double uk = phi_k + du;
    double rk = sqrt_a * sqrt_a * (1.0 - e * cEk) + dr;
    double ik = ep[kI0] + di + ep[kIdot] * tk;
    double su, cu;
    sincos(uk, &su, &cu);
    double x_op = rk * cu;
    double y_op = rk * su;
    double omega_k = ep[kOmegaBig]
                     + (ep[kOmegaDot] - kOmegaEarth) * tk
                     - kOmegaEarth * ep[kToe];
    double so, co, si, ci;
    sincos(omega_k, &so, &co);
    sincos(ik, &si, &ci);
    x[i] = x_op * co - y_op * ci * so;
    y[i] = x_op * so + y_op * ci * co;
    z[i] = y_op * si;
    dtsv[i] = dts;
  }
}

// -- batched Gauss-Newton position fix ---------------------------------------
//
// Port of ops/pvt.py solve_fix_batch for the 4-unknown reporting path
// (clock_rate=False; the free-rate fifth unknown stays Python-only).
// sat_pos[E*3*n], delay[E*n], w[E*m] prebuilt weights (1/max(s,1e-6)^2
// with the height row appended when use_height), rec_pos0[E*4] or
// null, crf[E] per-epoch clock_rate_fix.  Outputs as in FixBatch; cov
// is [E*16].  Returns 0, or -1 on any singular normal-equation solve
// (caller falls back to the Python path, matching np.linalg.solve's
// batch-wide LinAlgError), or -2 if only the covariance inversion was
// singular (caller sets cov=None; fix outputs remain valid).
extern "C" int32_t gsdr_fix_batch(
    const double* sat_pos, const double* delay, const double* w,
    const double* rec_pos0, const double* crf, int64_t E, int64_t n,
    int32_t max_it, double max_residual, double t0_guess,
    int32_t use_height, double height, double height_dev,
    double* pos_out, double* residual_out, double* range_out,
    double* meas_out, int64_t* n_iter_out, double* cov_out,
    double* res_m_out) {
  (void)height_dev;  // folded into w by the caller
  const int nu = 4;
  const int64_t m = n + (use_height ? 1 : 0);
  const double ab2 = 1.0 / ((1.0 - kWgsF) * (1.0 - kWgsF));
  bool cov_singular = false;
  double* cdt = new double[n];
  double* dp = new double[3 * n];
  double* rng = new double[n];

  for (int64_t ei = 0; ei < E; ++ei) {
    const double* sp = sat_pos + ei * 3 * n;   // [3, n]
    const double* td = delay + ei * n;
    const double* we = w + ei * m;
    double scale = 1.0 - crf[ei];
    for (int64_t i = 0; i < n; ++i)
      cdt[i] = kGpsC * (td[i] - td[0]) * scale;

    double pos[4] = {0.0, 0.0, 0.0, 0.0};
    if (rec_pos0) {
      for (int j = 0; j < 4; ++j) pos[j] = rec_pos0[ei * 4 + j];
    }
    pos[0] = kGpsC * t0_guess;
    if (use_height) {
      if (pos[1] == 0.0 && pos[2] == 0.0) pos[1] = pos[2] = 3687000.0;
      double r2 = (kWgsA + height) * (kWgsA + height)
                  - pos[1] * pos[1] - pos[2] * pos[2];
      pos[3] = (1.0 - kWgsF) * std::sqrt(r2 > 0.0 ? r2 : 0.0);
    }

    std::memset(dp, 0, sizeof(double) * 3 * n);
    double residual = HUGE_VAL;
    int it = 0;
    bool singular = false;
    while (it < max_it && residual > max_residual) {
      // ranges against the previous iteration's Sagnac displacement,
      // then refresh it (ops/pvt.py:379-383 ordering)
      for (int64_t i = 0; i < n; ++i) {
        double dx = sp[i] - pos[1] - dp[i];
        double dy = sp[n + i] - pos[2] - dp[n + i];
        double dz = sp[2 * n + i] - pos[3] - dp[2 * n + i];
        rng[i] = std::sqrt(dx * dx + dy * dy + dz * dz);
      }
      double vx = -pos[2] * kOmegaEarth, vy = pos[1] * kOmegaEarth;
      for (int64_t i = 0; i < n; ++i) {
        double dt_i = rng[i] / kGpsC;
        dp[i] = vx * dt_i;
        dp[n + i] = vy * dt_i;
        dp[2 * n + i] = 0.0;
      }
      // normal equations J'W J delta = -J'W f accumulated directly
      // (the jacobian uses the raw satellite positions, pvt.py:197)
      double jtj[16] = {0};
      double rhs[4] = {0};
      for (int64_t i = 0; i < m; ++i) {
        double jrow[4];
        double f;
        if (i < n) {
          jrow[0] = -1.0;
          jrow[1] = (pos[1] - sp[i]) / rng[i];
          jrow[2] = (pos[2] - sp[n + i]) / rng[i];
          jrow[3] = (pos[3] - sp[2 * n + i]) / rng[i];
          f = rng[i] - pos[0] - cdt[i];
        } else {
          double r_ell = std::sqrt(pos[1] * pos[1] + pos[2] * pos[2]
                                   + ab2 * pos[3] * pos[3]);
          jrow[0] = 0.0;
          jrow[1] = pos[1] / r_ell;
          jrow[2] = pos[2] / r_ell;
          jrow[3] = ab2 * pos[3] / r_ell;
          f = r_ell - (kWgsA + height);
        }
        double wi = we[i];
        for (int r = 0; r < 4; ++r) {
          double jw = jrow[r] * wi;
          rhs[r] += jw * f;
          for (int c = r; c < 4; ++c) jtj[r * 4 + c] += jw * jrow[c];
        }
      }
      for (int r = 1; r < 4; ++r)
        for (int c = 0; c < r; ++c) jtj[r * 4 + c] = jtj[c * 4 + r];
      double delta[4] = {-rhs[0], -rhs[1], -rhs[2], -rhs[3]};
      if (!solve_small(jtj, delta, nu)) { singular = true; break; }
      double nrm = 0.0;
      for (int j = 0; j < 4; ++j) {
        pos[j] += delta[j];
        nrm += delta[j] * delta[j];
      }
      residual = std::sqrt(nrm);
      ++it;
    }
    if (singular) {
      delete[] cdt; delete[] dp; delete[] rng;
      return -1;
    }

    // final recompute at the converged position: Sagnac restarts from
    // dp=0 and converges in <=3 passes (pvt.py:415-431), so reported
    // ranges/covariances depend only on the final position
    double vx = -pos[2] * kOmegaEarth, vy = pos[1] * kOmegaEarth;
    std::memset(dp, 0, sizeof(double) * 3 * n);
    for (int pass = 0; pass < 3; ++pass) {
      for (int64_t i = 0; i < n; ++i) {
        double dx = sp[i] - pos[1] - dp[i];
        double dy = sp[n + i] - pos[2] - dp[n + i];
        double dz = sp[2 * n + i] - pos[3] - dp[2 * n + i];
        rng[i] = std::sqrt(dx * dx + dy * dy + dz * dz);
        double dt_i = rng[i] / kGpsC;
        dp[i] = vx * dt_i;
        dp[n + i] = vy * dt_i;
      }
    }
    for (int64_t i = 0; i < n; ++i) {
      double dx = sp[i] - pos[1] - dp[i];
      double dy = sp[n + i] - pos[2] - dp[n + i];
      double dz = sp[2 * n + i] - pos[3] - dp[2 * n + i];
      rng[i] = std::sqrt(dx * dx + dy * dy + dz * dz);
    }
    double jtj[16] = {0};
    for (int64_t i = 0; i < m; ++i) {
      double jrow[4];
      if (i < n) {
        jrow[0] = -1.0;
        jrow[1] = (pos[1] - sp[i]) / rng[i];
        jrow[2] = (pos[2] - sp[n + i]) / rng[i];
        jrow[3] = (pos[3] - sp[2 * n + i]) / rng[i];
      } else {
        double r_ell = std::sqrt(pos[1] * pos[1] + pos[2] * pos[2]
                                 + ab2 * pos[3] * pos[3]);
        jrow[0] = 0.0;
        jrow[1] = pos[1] / r_ell;
        jrow[2] = pos[2] / r_ell;
        jrow[3] = ab2 * pos[3] / r_ell;
      }
      double wi = we[i];
      for (int r = 0; r < 4; ++r)
        for (int c = r; c < 4; ++c)
          jtj[r * 4 + c] += jrow[r] * wi * jrow[c];
    }
    for (int r = 1; r < 4; ++r)
      for (int c = 0; c < r; ++c) jtj[r * 4 + c] = jtj[c * 4 + r];
    if (!inv_small(jtj, cov_out + ei * 16, 4)) cov_singular = true;

    for (int j = 0; j < 4; ++j) pos_out[ei * 4 + j] = pos[j];
    residual_out[ei] = residual;
    n_iter_out[ei] = it;
    for (int64_t i = 0; i < n; ++i) {
      range_out[ei * n + i] = rng[i];
      meas_out[ei * n + i] = cdt[i] + pos[0];
      res_m_out[ei * n + i] = rng[i] - pos[0] - cdt[i];
    }
  }
  delete[] cdt; delete[] dp; delete[] rng;
  return cov_singular ? -2 : 0;
}

// -- per-segment code-phase sigma / slope ------------------------------------
//
// Port of models/pseudorange.py _sigma_and_slope.  snos[n]/cps[n] are
// one satellite's (already unwrapped/smoothed) series; segments anchor
// to the absolute stream grid ((sno-1)/no_sec).  `hist` is the
// engine's running slope history (f64[max_hist] ring, oldest first);
// hist_len is in/out.  Outputs sig_out/slp_out per entry.
extern "C" void gsdr_sigma_slope(
    const int64_t* snos, const double* cps, int64_t n, int64_t no_sec,
    int64_t n_cyc, double cap, double m_per_smp, double* hist,
    int64_t* hist_len, int64_t max_hist, double* sig_out,
    double* slp_out) {
  int64_t hl = *hist_len;
  int64_t a = 0;
  while (a < n) {
    int64_t seg = (snos[a] - 1) / no_sec;
    int64_t b = a + 1;
    while (b < n && (snos[b] - 1) / no_sec == seg) ++b;
    int64_t cnt = b - a;
    double sigma, slope;
    if (cnt > 3) {
      // LS slope + residual std over segment-centered coordinates
      // (exact zero-mean residual identity, pseudorange.py:253-271)
      double sx = 0, sy = 0, sxx = 0, sxy = 0, syy = 0;
      for (int64_t i = a; i < b; ++i) {
        double xi = (double)(snos[i] - snos[a]);
        double yi = cps[i] - cps[a];
        sx += xi; sy += yi; sxx += xi * xi; sxy += xi * yi;
        syy += yi * yi;
      }
      double c = (double)cnt;
      double mx = sx / c, my = sy / c;
      double var_x = sxx / c - mx * mx;
      double cov = sxy / c - mx * my;
      double var_y = syy / c - my * my;
      double sl = var_x > 0.0 ? cov / var_x : 0.0;
      double v = var_y - sl * cov;
      sigma = std::sqrt(v > 0.0 ? v : 0.0);
      if (hl >= max_hist) {
        // drop ONE oldest entry per append, like the Python walk's
        // `del hist[0]` — >= (not ==) so a history handed in above
        // max_hist (e.g. resumed under a different n_cyc) can never
        // write past the caller's max_hist+1 buffer
        std::memmove(hist, hist + 1, sizeof(double) * (hl - 1));
        --hl;
      }
      hist[hl++] = sl / (double)n_cyc;
    } else {
      sigma = 0.5;
    }
    if (hl > 4) {
      double s = 0.0;
      for (int64_t k = 0; k < hl; ++k) s += hist[k];
      slope = s / (double)hl;
    } else {
      slope = 0.0;
    }
    if (slope > cap) slope = cap;
    if (slope < -cap) slope = -cap;
    for (int64_t i = a; i < b; ++i) {
      sig_out[i] = sigma * m_per_smp;
      slp_out[i] = slope;
    }
    a = b;
  }
  *hist_len = hl;
}

// -- code-phase overflow unwrap ----------------------------------------------
//
// Port of runtime/evaluator.py unwrap_code_phases' vectorized core:
// cumulative wrap-sign correction plus the physically-impossible-step
// scan.  cps is corrected IN PLACE; step indices i (between entry i
// and i+1) with |d corrected| > 1 + (gap-1)*0.2 are written to
// err_idx (caller does the per-stream voting/logging).  Returns the
// number of flagged steps.
extern "C" int64_t gsdr_unwrap(const int64_t* snos, double* cps,
                               int64_t n, double cs, double diff_tol,
                               int64_t* err_idx, int64_t max_err) {
  double off = 0.0;
  int64_t n_err = 0;
  for (int64_t i = 1; i < n; ++i) {
    double d = (cps[i - 1] - off) - cps[i];  // RAW neighbour difference
    double ad = std::fabs(std::fabs(d) - cs);
    if (ad <= diff_tol) off += (d > 0 ? 1.0 : (d < 0 ? -1.0 : 0.0)) * cs;
    cps[i] += off;
    double step = std::fabs(cps[i] - cps[i - 1]);
    double gap = (double)(snos[i] - snos[i - 1]);
    if (step > 1.0 + (gap - 1.0) * 0.2 && n_err < max_err)
      err_idx[n_err++] = i - 1;
  }
  return n_err;
}
