"""Differential validation UNDER DEGRADATION (VERDICT r4 #4).

The mild differential capture (test_reference_differential) never
exercises either pipeline's elasticity.  This capture does, on purpose:

  * noise at 2x the mild capture (correlations ~5-13 sigma, grazing
    the reference's 8 sigma acquisition/quality gates),
  * a 2x-stronger oscillator offset plus drift,
  * a mid-capture SAMPLE GAP (6758 samples ~ 3.3 ms, deliberately NOT
    a code-period multiple) — every channel's code phase jumps by the
    same 614 samples at once, which is exactly the correlated-step
    signature the >=3-satellite phase-error vote exists for
    (/root/reference/src/gpseval.py:436-457; ours:
    runtime/evaluator.py _prep_code_phases).

Event-aligned claims: BOTH pipelines trip their phase-error machinery
(not zero, and not constantly), BOTH keep tracking the same satellites
through the event, and BOTH re-anchor and produce agreeing fixes after
it.  The reference run is executed upstream code (tests/ref_driver.py),
never a reimplementation.
"""

import os

import numpy as np
import pytest

from gps_sdr.config import ReceiverConfig
from gps_sdr.models.scenario import make_scenario
from gps_sdr.models.scenario_jax import DeviceScenarioSynth
from gps_sdr.runtime.sources import pack_iq, replay_blocks
from tests.conftest import _SYNTH_CACHE, reference_result

SEC = 64.0
SEED = 2
OSC_PPM = 0.6             # 2x the mild capture; still inside the
                          # reference's +-5 kHz hard-coded sweep
OSC_PPM_RATE = 3.0e-4
NOISE_STD = 2.0           # correlations graze the 8 sigma gate
SCALE = 0.05
GAP_AT_SEC = 30.0         # sample-gap event time
GAP_SAMPLES = 6758        # ~3.3 ms; 6758 % 2048 = 614-sample cp jump

CFG = ReceiverConfig()


def _scenario():
    return make_scenario(CFG, n_sats=8, duration_sec=SEC + 12.0,
                         seed=SEED, osc_ppm=OSC_PPM,
                         osc_ppm_rate=OSC_PPM_RATE)


def _capture_path():
    os.makedirs(_SYNTH_CACHE, exist_ok=True)
    path = os.path.join(_SYNTH_CACHE, "degraded_capture_v1.bin")
    if os.path.exists(path):
        return path
    scn = _scenario()
    dev = DeviceScenarioSynth(scn, noise_std=NOISE_STD)
    n_blocks = int(round(SEC / CFG.block_sec))
    step = CFG.no_sec
    words = []
    done = 0
    while done < n_blocks:
        k = min(step, n_blocks - done)
        chunk = np.asarray(dev.chunk(done, k))
        words.append(pack_iq(SCALE * chunk).ravel())
        done += k
    raw = np.concatenate(words)
    # the event: drop GAP_SAMPLES samples mid-capture.  Every
    # receiver channel sees the same instantaneous code-phase jump —
    # the correlated signature of a stream loss.
    gap_at = int(GAP_AT_SEC * CFG.sample_rate)
    raw = np.concatenate([raw[:gap_at], raw[gap_at + GAP_SAMPLES:]])
    tmp = path + ".tmp"
    raw.tofile(tmp)
    os.replace(tmp, path)
    return path


@pytest.fixture(scope="module")
def ref_result():
    return reference_result("degraded_refresult_v1.pkl", _capture_path)


@pytest.fixture(scope="module")
def ours():
    from gps_sdr.runtime.session import Session

    path = _capture_path()
    session = Session(CFG, record_epochs_to="memory")
    session.run_source(replay_blocks(path, CFG))
    return session


def _event_posix(fixes):
    """POSIX time of the gap event: fixes start ~13 s into the capture
    (sweep + first subframes), so anchor on the first fix time."""
    t0 = fixes[0][0]
    # first fix happens after sweep (1 s) + framing+ephemeris (~12 s)
    return t0, t0 - 14.0 + GAP_AT_SEC


def test_both_pipelines_trip_phase_error(ref_result, ours):
    """The correlated code-phase step must fire the >=3-satellite vote
    on BOTH pipelines — and only around the one injected event (a
    handful of trips at most, not a constant stream)."""
    session = ours
    ref_n = ref_result.get("n_phase_errors", 0)
    our_n = session.evaluator.n_phase_errors
    assert ref_n >= 1, "reference never tripped its phase-error vote"
    assert our_n >= 1, "we never tripped the phase-error vote"
    assert ref_n <= 4 and our_n <= 4, (
        f"phase-error storm: ref {ref_n}, ours {our_n}")


def test_same_satellites_through_event(ref_result, ours):
    """Both pipelines acquire the same PRN set, and both still track
    (code phases flowing) the same satellites after the event."""
    session = ours
    ref_prns = {s for _, s, _, _ in ref_result["found"]}
    our_prns = {int(p) for p in session.receiver.slots.slot_prn
                if p != 0}
    assert len(ref_prns & our_prns) >= 6, (ref_prns, our_prns)

    # satellites with code phases in the POST-event tail (last 20 s)
    tail_no = int((SEC - 20.0) / CFG.block_sec)

    def tail_sats_ref():
        return {s for s, lst in ref_result["coph"].items()
                if any(n >= tail_no for n, _ in lst)}

    our_tail = set()
    for rec in session.records:
        for sat, lst in rec[2].items():
            if any(int(n) >= tail_no for n, _ in lst):
                our_tail.add(sat)
    rt = tail_sats_ref()
    assert len(rt & our_tail) >= 6, (rt, our_tail)


def test_fixes_reconverge_after_event(ref_result, ours):
    """Both pipelines produce fixes before AND after the event, and the
    post-event trajectories agree within the capture's (degraded)
    scatter."""
    session = ours
    scn = _scenario()
    truth = scn.rec_ecef
    ref_fixes = np.array(ref_result["fixes"], np.float64)
    our_fixes = np.array([[p[0], p[1], p[2], p[3]]
                          for p in session.evaluator.positions],
                         np.float64)
    assert len(ref_fixes) >= 40 and len(our_fixes) >= 40

    t0, ev_t = _event_posix(ref_fixes)
    for fixes, who in ((ref_fixes, "ref"), (our_fixes, "ours")):
        pre = fixes[fixes[:, 0] < ev_t - 1.0]
        post = fixes[fixes[:, 0] > ev_t + 10.0]
        assert len(pre) >= 10, f"{who}: no pre-event fixes"
        assert len(post) >= 10, f"{who}: did not re-converge"

    # post-event accuracy and agreement
    post_r = ref_fixes[ref_fixes[:, 0] > ev_t + 10.0]
    post_o = our_fixes[our_fixes[:, 0] > ev_t + 10.0]
    err_r = np.linalg.norm(post_r[:, 1:4] - truth, axis=1)
    err_o = np.linalg.norm(post_o[:, 1:4] - truth, axis=1)
    scatter = float(np.mean(err_r))
    assert np.mean(err_o) < scatter + max(2.0, 0.5 * scatter), (
        f"post-event: ours {np.mean(err_o):.1f} m vs ref "
        f"{scatter:.1f} m")
    rb = {round(t, 3): xyz for t, *xyz in post_r}
    ob = {round(t, 3): xyz for t, *xyz in post_o}
    common = sorted(set(rb) & set(ob))
    assert len(common) >= 10, f"only {len(common)} common post epochs"
    d = np.array([np.linalg.norm(np.subtract(rb[t], ob[t]))
                  for t in common])
    assert np.median(d) < max(2.0, scatter), (
        f"median post-event separation {np.median(d):.2f} m")
