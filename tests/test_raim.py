"""RAIM fault detection & exclusion on a faulted-satellite capture.

One satellite's SV clock is faulted by 1 us (~300 m of pseudorange)
without touching its broadcast clock model — the canonical integrity
fault.  The reference has no per-satellite integrity test: its
MAX_RESIDUAL gate judges whole fixes, so a faulty SV silently biases
every epoch it participates in.  Here the chi-square residual test
names the satellite and the exclusion search removes it.

The capture is cached under .synth_cache/ (~80 MB).
"""

import os

import numpy as np
import pytest

from gps_sdr.config import ReceiverConfig
from gps_sdr.models.scenario import make_scenario
from gps_sdr.models.scenario_jax import DeviceScenarioSynth
from gps_sdr.runtime.sources import pack_iq, replay_blocks
from tests.conftest import _SYNTH_CACHE

SEC = 30.0
FAULT_S = 1.0e-6                 # ~300 m
# carrier smoothing exercises the harder RAIM regime: centimeter-class
# fitted sigmas that must be floored or benign systematics read as
# faults and no exclusion can pass the absolute gate
CFG = ReceiverConfig(raim=True, carrier_smoothing=64)


def _scenario():
    scn = make_scenario(CFG, n_sats=7, duration_sec=SEC + 12.0, seed=35)
    scn.sats[2].fault_dtsv = FAULT_S
    return scn


def _capture_path():
    os.makedirs(_SYNTH_CACHE, exist_ok=True)
    path = os.path.join(_SYNTH_CACHE, "faulted_capture_v1.bin")
    if os.path.exists(path):
        return path
    scn = _scenario()
    dev = DeviceScenarioSynth(scn, noise_std=0.5)
    n_blocks = int(round(SEC / CFG.block_sec))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        done = 0
        while done < n_blocks:
            k = min(CFG.no_sec, n_blocks - done)
            pack_iq(0.13 * np.asarray(dev.chunk(done, k))).tofile(f)
            done += k
    os.replace(tmp, path)
    return path


def _run(cfg):
    from gps_sdr.runtime.session import Session

    session = Session(cfg)
    session.run_source(replay_blocks(_capture_path(), cfg))
    return session.evaluator


@pytest.fixture(scope="module")
def evaluators():
    ev_raim = _run(CFG)
    ev_plain = _run(ReceiverConfig(carrier_smoothing=64))
    return _scenario(), ev_raim, ev_plain


def test_fault_biases_unprotected_fix(evaluators):
    scn, ev_raim, ev_plain = evaluators
    mean, dev, n, _ = ev_plain.stat
    err = np.linalg.norm(mean - scn.rec_ecef)
    assert err > 15.0, (
        f"unprotected error only {err:.1f} m - fault too weak to test")


def test_raim_names_and_excludes_the_faulted_sat(evaluators):
    scn, ev_raim, ev_plain = evaluators
    bad_prn = scn.sats[2].prn
    assert ev_raim.raim_events, "RAIM never tripped"
    assert {e[1] for e in ev_raim.raim_events} == {bad_prn}, (
        f"excluded {set(e[1] for e in ev_raim.raim_events)}, "
        f"faulted {bad_prn}")
    # an excluded satellite must not re-trip detection every interval
    assert len(ev_raim.raim_events) <= 2
    # detection statistic collapsed after exclusion
    t, sat, before, after = ev_raim.raim_events[0]
    assert before > 20 * after


def test_raim_repairs_the_fix(evaluators):
    scn, ev_raim, ev_plain = evaluators
    mean, dev, n, _ = ev_raim.stat
    err = np.linalg.norm(mean - scn.rec_ecef)
    plain_err = np.linalg.norm(ev_plain.stat[0] - scn.rec_ecef)
    assert err < 6.0, f"RAIM-protected error {err:.2f} m"
    assert err < 0.2 * plain_err
