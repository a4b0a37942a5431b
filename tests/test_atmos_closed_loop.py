"""Closed-loop atmospheric correction: the full receiver on a capture
with injected Klobuchar + Saastamoinen delays.

The scenario broadcasts the page-18 coefficients in its own nav
message; the receiver must cold-acquire, track, decode the page, and
correct its pseudoranges — producing a fix markedly better than the
same epochs evaluated without corrections (the reference's permanent
condition, README.md:26).

The capture is cached under .synth_cache/ (~80 MB); the first build
synthesizes 30 s of IQ.
"""

import os

import numpy as np
import pytest

from gps_sdr.config import ReceiverConfig
from gps_sdr.models.scenario import make_scenario
from gps_sdr.runtime.evaluator import EpochInput
from gps_sdr.models.scenario_jax import DeviceScenarioSynth
from gps_sdr.runtime.sources import pack_iq, replay_blocks
from tests.conftest import _SYNTH_CACHE

SEC = 30.0
CFG = ReceiverConfig(iono_corr=True, tropo_corr=True)


def _scenario():
    return make_scenario(CFG, n_sats=7, duration_sec=SEC + 12.0,
                         seed=21, iono=True, tropo=True)


def _capture_path():
    os.makedirs(_SYNTH_CACHE, exist_ok=True)
    path = os.path.join(_SYNTH_CACHE, "atmos_capture_v1.bin")
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
            pack_iq(0.13 * np.asarray(dev.chunk(done, k))).tofile(f)
            done += k
    os.replace(tmp, path)
    return path


@pytest.fixture(scope="module")
def replayed():
    from gps_sdr.runtime.session import Session

    path = _capture_path()
    scn = _scenario()
    session = Session(CFG, record_epochs_to="unused")  # keep records
    summary = session.run_source(replay_blocks(path, CFG))
    return scn, session, summary


def test_corrected_fix_beats_uncorrected(replayed):
    from gps_sdr.runtime.session import Session

    scn, session, summary = replayed
    ev = session.evaluator
    assert ev.iono_params is not None, "page 18 never decoded"
    mean, dev, n, n_out = ev.stat
    assert n >= 8, f"only {n} averaged fixes"
    err_corr = np.linalg.norm(mean - scn.rec_ecef)

    # identical epochs, corrections off (the reference's condition)
    cfg_off = ReceiverConfig()
    s2 = Session(cfg_off)
    s2.run_epoch_records(session.records)
    mean2, dev2, n2, _ = s2.evaluator.stat
    err_uncorr = np.linalg.norm(mean2 - scn.rec_ecef)

    assert err_corr < 6.0, f"corrected error {err_corr:.2f} m"
    assert err_uncorr > err_corr + 1.0, (
        f"uncorrected {err_uncorr:.2f} m vs corrected {err_corr:.2f} m "
        "- atmosphere correction bought nothing")


def test_almanac_maintenance_resweeps(replayed):
    """cfg.almanac_resweep_sec: with a cached almanac and a position,
    the session periodically re-arms the cold sweep from the almanac
    prediction (narrowed grid) — channels stay locked and fixes keep
    flowing through the maintenance sweeps."""
    from gps_sdr.models.almanac import almanac_from_ephem
    from gps_sdr.runtime.session import Session
    from gps_sdr.utils.io import save_almanac

    scn, session, summary = replayed
    alm_path = os.path.join(_SYNTH_CACHE, "atmos_almanac.json")
    save_almanac(alm_path,
                 {s.prn: almanac_from_ephem(s.eph) for s in scn.sats})
    cfg = CFG.replace(almanac_resweep_sec=2.0)
    s2 = Session(cfg, almanac_cache_path=alm_path)
    s2.run_source(replay_blocks(_capture_path(), cfg))
    st = s2.receiver.status
    assert st.warm_sweeps >= 2, f"only {st.warm_sweeps} warm sweeps"
    mean, dev, n, _ = s2.evaluator.stat
    assert np.linalg.norm(mean - scn.rec_ecef) < 6.0
    # the tracked set survived the maintenance sweeps
    assert len(s2.receiver.slots.active) >= 6


def test_preloaded_iono_corrects_from_first_fix(replayed):
    """Page 18 repeats only every 30 s of broadcast, so a cold start
    has an iono-blind window before the first SF4 decode (real-receiver
    physics: the page cycles every 12.5 min on the air, which is why
    receivers cache the coefficients).  With the coefficients preloaded
    — the cache warm start, like preloaded ephemerides — every fix from
    the very first one carries the full correction."""
    from gps_sdr.runtime.evaluator import Evaluator

    scn, session, summary = replayed
    ev = Evaluator(CFG, iono_params={"alpha": scn.iono_alpha,
                                     "beta": scn.iono_beta})
    for rec in session.records:
        ev.process(EpochInput(*rec))
    assert len(ev.positions) >= 5
    # single-epoch fixes scatter ~10 m from code noise alone; the bias
    # is what the correction removes (measured: 0.23 m mean here vs
    # 2.9 m for the cold start whose early fixes ran iono-blind)
    first = np.asarray(ev.positions[0][1:])
    assert np.linalg.norm(first - scn.rec_ecef) < 30.0
    mean, dev, n, _ = ev.stat
    assert np.linalg.norm(mean - scn.rec_ecef) < 2.0
