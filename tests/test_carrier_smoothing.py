"""Carrier-smoothed pseudoranges (Hatch filter) — a capability the
reference lacks (models/pseudorange.py _hatch).

The tracked carrier's integrated Doppler predicts code-phase motion
exactly (code Doppler = f/1540 chips/s), so the filter averages code
noise over N blocks with zero lag on real dynamics.  Pinned here:
(1) noise reduction and zero-lag tracking of dynamic truth,
(2) cross-call state carry-over (chunked == one call),
(3) end-to-end fix improvement on the geometric closed loop with the
    carrier frequencies an ideal tracker would report.
"""

import numpy as np
import pytest

from gps_sdr.config import DEFAULT as CFG
from gps_sdr.config import L1_FREQ, ReceiverConfig
from gps_sdr.models.pseudorange import PseudorangeEngine
from gps_sdr.runtime.evaluator import EpochInput, Evaluator
from tests.test_pipeline import ideal_measurements, make_scenario


def _truth_series(rng, cfg, n):
    """(snos, cp_true, freqs): code phase driven by a dynamic Doppler
    profile through the exact code-carrier coupling."""
    k = -cfg.n_cyc * cfg.code_samples / L1_FREQ   # engine sign: -FRQ*|k|
    snos = np.arange(1, n + 1, dtype=np.int64)
    t = snos * cfg.n_cyc * 1e-3
    f = 1500.0 + 800.0 * np.sin(2 * np.pi * t / 30.0)   # Hz, dynamic
    cp = np.empty(n)
    cp[0] = 400.0
    fmid = 0.5 * (f[1:] + f[:-1])
    cp[1:] = cp[0] + np.cumsum(k * fmid)
    return snos, cp, f


def _engine(cfg):
    return PseudorangeEngine(5, cfg)


def test_hatch_reduces_noise_without_lag():
    cfg = ReceiverConfig(carrier_smoothing=64)
    rng = np.random.default_rng(3)
    snos, truth, f = _truth_series(rng, cfg, 600)
    noisy = truth + rng.normal(0, 0.05, truth.shape)    # ~7 m code noise
    sm = _engine(cfg)._hatch(snos, noisy, f)
    raw_rms = float(np.sqrt(np.mean((noisy - truth) ** 2)))
    # skip the convergence transient (first ~2 windows)
    sl = slice(128, None)
    sm_rms = float(np.sqrt(np.mean((sm[sl] - truth[sl]) ** 2)))
    assert sm_rms < raw_rms / 3.5, (sm_rms, raw_rms)
    # zero lag: the mean error stays unbiased despite the dynamics
    assert abs(np.mean(sm[sl] - truth[sl])) < 0.01


def test_hatch_state_carries_across_calls():
    cfg = ReceiverConfig(carrier_smoothing=32)
    rng = np.random.default_rng(4)
    snos, truth, f = _truth_series(rng, cfg, 300)
    noisy = truth + rng.normal(0, 0.05, truth.shape)
    one = _engine(cfg)._hatch(snos, noisy, f)
    eng = _engine(cfg)
    parts = []
    for i in range(0, 300, 31):                  # chunk-sized calls
        parts.append(eng._hatch(snos[i:i + 31], noisy[i:i + 31],
                                f[i:i + 31]))
    np.testing.assert_allclose(np.concatenate(parts), one, atol=1e-9)


def test_hatch_resets_on_gap_and_jump():
    cfg = ReceiverConfig(carrier_smoothing=32)
    rng = np.random.default_rng(5)
    snos, truth, f = _truth_series(rng, cfg, 120)
    noisy = truth + rng.normal(0, 0.05, truth.shape)
    eng = _engine(cfg)
    eng._hatch(snos, noisy, f)
    # a >1 s stream gap resets the filter: first output == raw input
    far = snos + 10_000
    out = eng._hatch(far[:10], noisy[:10], f[:10])
    assert out[0] == noisy[0]
    # a code-phase jump (phase error) also resets
    out2 = eng._hatch(far[10:20] + 1, noisy[10:20] + 800.0, f[10:20])
    assert out2[0] == noisy[10] + 800.0


def test_closed_loop_fixes_improve(scenario=None):
    scn = make_scenario(CFG, n_sats=6, duration_sec=52.0, seed=3)
    cfg_s = CFG.replace(carrier_smoothing=96)
    n_sec = 48
    coph, frames = ideal_measurements(scn, n_sec)
    rng = np.random.default_rng(11)
    sigma_cp = 0.05                               # ~7 m code noise
    noisy = {prn: [(sno, cp + rng.normal(0, sigma_cp))
                   for sno, cp in lst] for prn, lst in coph.items()}

    # the carrier freq an ideal tracker would report, per block
    fs = CFG.sample_rate
    n_blocks = n_sec * CFG.no_sec
    centers = scn.t_rx0 + (np.arange(n_blocks) * CFG.ngps
                           + CFG.ngps / 2) / fs
    cfrq = {}
    for sat in scn.sats:
        tau0, _ = scn.sat_states(centers - 0.5, sat)   # propagation delay
        tau1, _ = scn.sat_states(centers + 0.5, sat)
        f_geo = -(tau1 - tau0) * L1_FREQ          # -d(tau)/dt * L1
        cfrq[sat.prn] = [(b + 1, float(f_geo[b]))
                         for b in range(n_blocks)]

    def run(cfg, with_freq):
        ev = Evaluator(cfg)
        for sec in range(n_sec):
            lo, hi = sec * cfg.no_sec + 1, (sec + 1) * cfg.no_sec + 1
            sec_frames = []
            sec_coph = {}
            sec_cfrq = {}
            for sat in scn.sats:
                sec_frames += [dict(sf) for st, sf in frames[sat.prn]
                               if lo * cfg.ngps <= st + 6 * fs
                               < hi * cfg.ngps]
                sec_coph[sat.prn] = [(s, c) for s, c in noisy[sat.prn]
                                     if lo <= s < hi]
                if with_freq:
                    sec_cfrq[sat.prn] = [(s, f) for s, f
                                         in cfrq[sat.prn] if lo <= s < hi]
            ev.process(EpochInput(0, sec_frames, sec_coph,
                                  carrier_freqs=sec_cfrq or None))
        return ev

    ev_raw = run(CFG, False)
    ev_sm = run(cfg_s, True)
    assert ev_raw.stat is not None and ev_sm.stat is not None
    # per-fix scatter shrinks by ~sqrt(window)
    assert np.mean(ev_sm.stat[1]) < np.mean(ev_raw.stat[1]) / 2.5, \
        (ev_sm.stat[1], ev_raw.stat[1])
    # steady-state mean: skip the filter-convergence transient right
    # after the time references anchor (~first 5 s of fixes); smoothed
    # errors are correlated over the window, so compare full-run means
    # with a tolerant bound rather than per-fix
    tail_raw = np.asarray(ev_raw.all_pos)[160:]
    tail_sm = np.asarray(ev_sm.all_pos)[160:]
    err_raw = np.linalg.norm(np.mean(tail_raw, axis=0) - scn.rec_ecef)
    err_sm = np.linalg.norm(np.mean(tail_sm, axis=0) - scn.rec_ecef)
    assert err_sm < max(2.0 * err_raw, 5.0), (err_sm, err_raw)


def test_device_path_ships_carrier_freqs():
    """run_device with carrier_smoothing > 0 ships per-block freqs in
    the compact transport (3rd blocky column) and emits them aligned
    1:1 with the code phases."""
    from gps_sdr.models.sim_jax import JaxSynth
    from gps_sdr.models.simulator import SatSignal, random_bits
    from gps_sdr.runtime.receiver import Receiver

    cfg = ReceiverConfig(code_samples=256, n_cyc=8, corr_avg=4,
                         sweep_corr_avg=2, blocks_per_step=4,
                         max_sat=2, chunks_per_download=2,
                         carrier_smoothing=16)
    sats = [SatSignal(prn=5, doppler=987.0, code_delay=77.25,
                      nav_bits=random_bits(64, seed=1)),
            SatSignal(prn=9, doppler=-1350.0, code_delay=12.0,
                      nav_bits=random_bits(64, seed=2))]
    synth = JaxSynth(cfg, sats, noise_std=0.2, seed=9)
    r = Receiver(cfg)
    r.sweep_all = False
    for s in sats:
        r._activate(s.prn, s.doppler, int(s.code_delay) % cfg.code_samples)
    r._refresh_code_tables()
    eps = list(r.run_device(synth.chunk_planar, 4, chunk_blocks=24))
    got = 0
    for e in eps:
        assert e.carrier_freqs is not None
        for prn, lst in e.code_phases.items():
            flst = e.carrier_freqs[prn]
            assert [s for s, _ in flst] == [s for s, _ in lst]
            got += len(flst)
            # tracked freqs stay near the injected Doppler
            dop = {5: 987.0, 9: -1350.0}[prn]
            assert all(abs(f - dop) < 200.0 for _, f in flst)
    assert got > 50
