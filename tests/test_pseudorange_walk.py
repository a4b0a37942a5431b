"""Parity of the vectorized TOW walk vs the sequential reference walk.

`PseudorangeEngine.eval_code_phases` replaced its stream-by-stream walk
(evalCodePhase, /root/reference/src/gpslib.py:987-1037) with a
closed-form vectorized version; this pins the two as identical —
result tuples, ref_time roll-forward, and continuity state — on
randomized multi-call sequences crossing 6 s boundaries, with gaps,
stale entries, and all n_cyc modes.
"""

import copy

import numpy as np
import pytest

from gps_sdr.config import ReceiverConfig
from gps_sdr.models import orbits
from gps_sdr.models.navmsg import decode_subframe, encode_subframe
from gps_sdr.models.pseudorange import PseudorangeEngine, _linfit
from tests.test_navmsg import SF1, SF2, SF3


@pytest.fixture(autouse=True)
def _python_host_path(monkeypatch):
    """The oracle comparisons here pin EXACT equality of the TOW-walk
    vectorization; run both sides on the numpy path so sub-nm libm
    differences of the native core (tested separately in test_native)
    don't blur the 1e-9 assertions."""
    monkeypatch.setenv("GSDR_EVALCORE", "0")


def _oracle_eval(self, cpl, rel_corr=True):
    """The pre-vectorization sequential implementation (oracle)."""
    cfg = self.cfg
    cs, ngps, n_cyc, fs = (cfg.code_samples, cfg.ngps, cfg.n_cyc,
                           cfg.sample_rate)
    six_sec = int(6 * fs)
    result = []
    if cpl:
        if cpl[0][1] is None:
            self.phase_err_snos.append(cpl[0][0])
            self.asm.time_refs = []
            self._clear_ref()
            return result
        cpl = [e for e in cpl if e[0] > self.last_sno]
    if (self.ref_time is not None and self.asm.ephem_ok
            and self.asm.ephem["IODC"] != self.ref_ephem["IODC"]):
        self._clear_ref()
    if self.ref_time is None and self.asm.time_refs:
        self.ref_time = self.asm.time_refs[-1]
        self.ref_ephem = dict(self.asm.ephem)
    if not cpl or self.ref_time is None:
        return result

    week_num = self.ref_ephem["weekNum"]
    tow, st_raw = self.ref_time
    st_frac = st_raw % cs
    st = (st_raw // cs) * cs
    if st // ngps > self.last_sno:
        self.last_sno = st // ngps
        self.last_cp = st_frac
    snos = np.array([e[0] for e in cpl], dtype=np.int64)
    cps = np.array([e[1] for e in cpl], dtype=np.float64)
    gap = int(snos[0]) - self.last_sno
    if gap > self.MAX_GAP:
        self._clear_ref()
        return result
    if gap > self.MIN_GAP:
        if len(self.cp_hist) >= n_cyc // 2:
            hx, hy = zip(*self.cp_hist[-self.MAX_FIT:])
            sl, ic = _linfit(hx, hy)
            self.last_cp = float(sl * snos[0] + ic)
        else:
            self._clear_ref()
            return result
    ofl = self.last_cp // cs
    if ofl != 0:
        cps = cps + ofl * cs
    diff = self.last_cp - cps[0]
    if abs(abs(diff) - cs) <= self.DIFF_TOL:
        cps = cps + np.sign(diff) * cs
    sig_a, slp_a = self._sigma_and_slope(snos, cps)
    # single-segment lists (the per-chunk shape) have constant arrays
    assert np.all(sig_a == sig_a[0]) and np.all(slp_a == slp_a[0])
    sigma, slope = float(sig_a[0]), float(slp_a[0])
    self.cp_hist += list(zip(snos.tolist(), cps.tolist()))
    self.cp_hist = self.cp_hist[-self.MAX_FIT:]
    self.last_sno, self.last_cp = int(snos[-1]), float(cps[-1])

    offms = (tow % 2 ** (n_cyc // 32)) * 16 if n_cyc > 16 else 0
    while (st + six_sec) // ngps < snos[0]:
        st += six_sec
        tow += 1
        offms = (offms + 16) % n_cyc
    cp = cps[0]
    cyc_no = 0
    delta_st = offms * cs
    stream_no = (st + delta_st) // ngps
    code_no = (st + delta_st) // cs - stream_no * n_cyc
    idx = 0
    rows = []
    while idx < len(snos):
        if snos[idx] < stream_no:
            idx += 1
        elif snos[idx] > stream_no:
            stream_no += 1
            cyc_no += 1
            delta_st += ngps
        else:
            cp = cps[idx]
            corr_cp = (code_no + cp // cs - n_cyc // 2) * slope
            rows.append((tow, delta_st, st + delta_st + cp + corr_cp,
                         cyc_no))
            stream_no += 1
            cyc_no += 1
            delta_st += ngps
            idx += 1
        if delta_st >= six_sec:
            tow += 1
            cyc_no = 0
            st += six_sec
            offms = (offms + 16) % n_cyc
            delta_st = offms * cs
            if stream_no < snos[-1]:
                self.ref_time = (tow, int(st + cp % cs))
    if rows:
        tow_a = np.array([r[0] for r in rows], dtype=np.float64)
        dst_a = np.array([r[1] for r in rows], dtype=np.float64)
        x, y, z, dtsv = orbits.ecef_coord(
            tow_a, self.ref_ephem, dt_from_tow=dst_a / fs,
            rel_corr=rel_corr)
        dtsv = np.broadcast_to(np.asarray(dtsv, np.float64), tow_a.shape)
        for i, (tw, _, smp_raw, cyc) in enumerate(rows):
            result.append((self.sat_no, int(tw), float(x[i]),
                           float(y[i]), float(z[i]),
                           smp_raw / fs + float(dtsv[i]),
                           int(week_num), int(cyc), sigma))
    return result


def _make_engine(cfg, tow0):
    eng = PseudorangeEngine(5, cfg)
    for sf_id, f in ((1, SF1), (2, SF2), (3, SF3)):
        d = decode_subframe(encode_subframe(sf_id, f, tow0 + sf_id))
        assert d is not None
        d["ST"] = (tow0 + sf_id) * 6 * int(cfg.sample_rate)
        d["SAT"] = 5
        eng.read_frame(d)
    assert eng.ephem_ok
    return eng


def _random_lists(rng, cfg, sno0, n_lists):
    """Chunk-shaped code-phase lists with drift, gaps, stale starts."""
    cs = cfg.code_samples
    lists = []
    sno = sno0
    cp = float(rng.uniform(0, cs))
    drift = float(rng.uniform(-0.006, 0.006)) * cfg.n_cyc  # per block
    for _ in range(n_lists):
        n = int(rng.integers(4, cfg.no_sec + 1))
        lst = []
        for _ in range(n):
            lst.append((sno, cp))
            # stay inside one ABSOLUTE reporting segment, like real
            # per-chunk lists ((sno-1)//no_sec constant within a chunk)
            seg_end = ((lst[0][0] - 1) // cfg.no_sec + 1) * cfg.no_sec
            step = 1 + (int(rng.integers(1, 5))
                        if rng.random() < 0.08 else 0)
            sno += step
            cp += drift * step
            if sno > seg_end:       # next list opens a new segment
                break
        lists.append(lst)
        if rng.random() < 0.2:      # inter-list gap
            sno += int(rng.integers(1, 200))
            cp += drift * 100
    return lists


@pytest.mark.parametrize("n_cyc", [32, 16, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_walk_matches_sequential(n_cyc, seed):
    cfg = ReceiverConfig(n_cyc=n_cyc)
    rng = np.random.default_rng(100 * n_cyc + seed)
    tow0 = int(rng.integers(1000, 100000))
    a = _make_engine(cfg, tow0)
    b = copy.deepcopy(a)
    # start near (sometimes before) the reference stream: exercises the
    # stale-entry skip and the initial fast-forward
    ref_sno = ((tow0 + 3) * 6 * int(cfg.sample_rate)) // cfg.ngps
    sno0 = ref_sno + int(rng.integers(-3, 40))
    for lst in _random_lists(rng, cfg, sno0, n_lists=30):
        got = a.eval_code_phases(list(lst))
        want = _oracle_eval(b, list(lst))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g[0] == w[0] and g[1] == w[1]
            assert g[2:6] == pytest.approx(w[2:6], abs=1e-9)
            assert g[6:8] == w[6:8]
            assert g[8] == pytest.approx(w[8], abs=1e-12)
        assert a.ref_time == b.ref_time
        assert a.last_sno == b.last_sno
        assert a.last_cp == pytest.approx(b.last_cp, abs=1e-9)
        assert a.cp_hist == pytest.approx(b.cp_hist)


def test_finish_deferred_mixed_preloaded_and_decoded_ephems():
    """Cross-satellite orbit batching must not key off any one
    satellite's ephemeris dict: a cache-preloaded ephemeris carries an
    extra "SAT" entry (models/ephemeris.py:51) that freshly decoded
    ones lack — batching the two together raised KeyError before
    EPHEM_KEYS pinned the field list."""
    from gps_sdr.models.pseudorange import (DeferredRows,
                                            finish_deferred)
    from gps_sdr.models.scenario import make_scenario

    cfg = ReceiverConfig()
    scn = make_scenario(cfg, n_sats=2, duration_sec=12.0, seed=6)
    eph_pre = dict(scn.sats[0].eph)
    eph_pre["SAT"] = scn.sats[0].prn          # cache-preloaded shape
    eph_dec = dict(scn.sats[1].eph)           # decoded shape: no SAT

    def rows(sat_no, eph):
        one = np.array([0], np.int64)
        return DeferredRows(
            sat_no=sat_no, week_num=scn.week,
            sigma=np.array([1.0]), ephem=eph,
            tow=np.array([scn.tow0], np.int64), delta_st=one,
            smp=np.array([1000.0]), cyc=one)

    res = finish_deferred([rows(scn.sats[0].prn, eph_pre),
                           rows(scn.sats[1].prn, eph_dec)], cfg)
    assert len(res) == 2
    # positions match per-satellite propagation exactly
    for i, eph in enumerate((eph_pre, eph_dec)):
        x, y, z, _ = orbits.ecef_coord(scn.tow0, eph,
                                       dt_from_tow=1 / cfg.sample_rate)
        assert np.allclose(res.pos[i], [x, y, z])
