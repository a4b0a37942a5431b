"""Golden 8-bit capture replay under the reference's hardest regime.

The reference's operating envelope is a +-2 ppm TCXO (README.md:204-217):
a common Doppler offset of ~ppm * 1575.42 Hz on every satellite, carrier
drift up to ~2.6 Hz/s (the reason for the PLL's 20 Hz/s slew limit and
drift feed-forward, gpslib.py:1226-1229), and a sample-clock skew that
walks every channel's code phase together at ~ppm * fs samples/s (what
the evaluator's unwrap + slope logic must absorb).  Its acceptance test
is a full position fix from an 8-bit .bin replay reproducing
49.082961 N, 8.307581 E +- ~1 m (README.md:177-185, gpsrecv.py:153-186).

This file is the repo's own test.bin analogue: a 40 s scenario at the
same coordinates, impaired with the full-envelope oscillator model
(+2 ppm offset, 2.6 Hz/s drift at L1, matching code-clock skew), is
quantized through the real 8-bit capture format and replayed through
the public Session pipeline — cold acquisition, tracking, nav decode,
ephemeris assembly, pseudoranges, Gauss-Newton fixes.

Expected result (pinned): mean fix within 8 m of 49.082961 N,
8.307581 E, 150 m height; every tracked channel's carrier shows the
common oscillator offset ramp (proof the drift feed-forward engaged).

The capture is cached under .synth_cache/ (~160 MB); the first build
synthesizes 40 s of IQ and takes minutes on the 1-core host.
"""

import os

import numpy as np
import pytest

from gps_sdr.config import L1_FREQ, ReceiverConfig
from gps_sdr.models.scenario import make_scenario
from gps_sdr.models.scenario_jax import DeviceScenarioSynth
from gps_sdr.runtime.sources import pack_iq, replay_blocks
from tests.conftest import _SYNTH_CACHE

SEC = 40.0
OSC_PPM = 2.0                    # full-envelope TCXO offset
OSC_PPM_RATE = 1.65e-3           # ppm/s -> 2.6 Hz/s at L1
# an uncorrected 2 ppm stick shifts every Doppler by ~ -3.15 kHz; a
# real user widens the search (the reference instead demands setting
# SDR_FREQCORR, README.md:204-217 — sdr_freq_corr_ppm here drives the
# live SDR the same way, but a replayed capture must be searched)
CFG = ReceiverConfig(min_freq=-8200.0, max_freq=2200.0,
                     solve_clock_rate=True)


def _scenario():
    return make_scenario(CFG, n_sats=8, duration_sec=SEC + 12.0, seed=3,
                         osc_ppm=OSC_PPM, osc_ppm_rate=OSC_PPM_RATE)


def _capture_path():
    """Build (once) and cache the impaired 8-bit capture."""
    os.makedirs(_SYNTH_CACHE, exist_ok=True)
    path = os.path.join(_SYNTH_CACHE, "impaired_capture_v3.bin")
    if os.path.exists(path):
        return path
    scn = _scenario()
    dev = DeviceScenarioSynth(scn, noise_std=0.5)
    n_blocks = int(round(SEC / CFG.block_sec))
    step = CFG.no_sec
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        done = 0
        while done < n_blocks:
            k = min(step, n_blocks - done)
            chunk = np.asarray(dev.chunk(done, k))
            # scale so the 8-sat sum (amplitudes 0.7-1.2 each) + noise
            # stays inside the 8-bit rails with ~4 sigma of headroom:
            # clipping is correlated across sats and biases the fix,
            # while the noise floor still spans ~8 LSB
            pack_iq(0.12 * chunk).tofile(f)
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


def test_golden_fix_under_full_envelope(replayed):
    scn, session, summary = replayed
    ev = session.evaluator
    mean, dev, n, n_out = ev.stat
    assert n >= 8, f"only {n} averaged fixes"
    err = np.linalg.norm(mean - scn.rec_ecef)
    assert err < 8.0, f"mean position error {err:.2f} m"
    assert ev.n_phase_errors == 0


def test_drift_feed_forward_tracked_the_ramp(replayed):
    """Locked channels' carrier must sit on true Doppler + the common
    oscillator ramp at end of run — the PLL followed ~2.6 Hz/s for
    40 s (~104 Hz of ramp) without losing lock."""
    from gps_sdr.ops.tracking import summarize_states

    scn, session, summary = replayed
    rec = session.receiver
    states = {k: np.asarray(v)
              for k, v in summarize_states(CFG, rec.states).items()}
    t_end = SEC - 1.0
    # d/dt clock_err: fractional rate error y(t) = 1e-6*(ppm + rate*t)
    y_end = 1e-6 * (OSC_PPM + OSC_PPM_RATE * t_end)
    common = -y_end * L1_FREQ                      # ~ -3.28 kHz
    n_checked = 0
    for slot, prn in enumerate(rec.slots.slot_prn):
        if prn == 0 or states["locked"][slot] < 0.5:
            continue
        sat = next(s for s in scn.sats if s.prn == prn)
        # numerical Doppler: -L1 * d(tau_prop)/dt at scenario end
        ts = scn.t_rx0 + np.array([t_end - 0.5, t_end + 0.5])
        tau, _ = scn.sat_states(ts, sat)
        dopp_true = -L1_FREQ * (tau[1] - tau[0])
        got = float(states["freq"][slot])
        assert abs(got - (dopp_true + common)) < 25.0, (
            f"PRN {prn}: tracked {got:.1f} Hz, expected "
            f"{dopp_true + common:.1f} Hz")
        n_checked += 1
    assert n_checked >= 4, f"only {n_checked} locked channels at end"


def test_code_clock_skew_absorbed(replayed):
    """+2 ppm sample-clock skew walks every code phase together at
    ~4.1 samples/s; fixes must keep flowing across the whole run (the
    unwrap/slope logic absorbed ~160 samples of common drift)."""
    scn, session, summary = replayed
    ev = session.evaluator
    assert len(ev.positions) >= 8
    # fixes span the tail of the run, not just one early burst
    t_span = ev.positions[-1][0] - ev.positions[0][0]
    assert t_span >= 5.0, f"fixes span only {t_span:.1f} s"


def test_clock_rate_estimated(replayed):
    """The evaluator's carrier-common-offset skew estimator must
    converge to the true fractional clock-rate error (~2.05e-6 at the
    run midpoint where fixes concentrate)."""
    scn, session, summary = replayed
    y_est = session.evaluator.clock_rate_est
    y_mid = 1e-6 * (OSC_PPM + OSC_PPM_RATE * 30.0)
    assert abs(y_est - y_mid) < 1.5e-7, f"y_est {y_est:.3e}"
