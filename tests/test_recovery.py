"""Fault injection: the six recovery semantics of SURVEY.md section 5.

(a) stream gap -> skip accounting -> channel erase (buffer overflow)
(b) signal loss -> correlation-quality collapse -> sweep request
(c) correlated code-phase jumps -> global time-reference reset
    (covered by tests/test_pipeline.py::test_phase_error_poison_pill)
(d) ephemeris change mid-run (IODC/IODE mismatch) -> assembler rebuild
(e) unhealthy SV -> excluded from time references
(f) fix-quality gates: outlier distance with speed allowance

The reference implements these at gpslib.py:1143-1146 (a),
gpslib.py:1134-1138 (b), gpseval.py:436-457 (c), gpslib.py:848-861 (d),
gpslib.py:735-737 (e), gpseval.py:344-354 (f); fault *injection* is new
here (the reference had no way to provoke them on demand).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from gps_sdr.config import ReceiverConfig
from gps_sdr.models.ephemeris import EphemerisAssembler, SatStatus
from gps_sdr.models.navmsg import encode_subframe, decode_subframe
from gps_sdr.models.pseudorange import PseudorangeEngine
from gps_sdr.models.simulator import SatSignal, random_bits, synth_stream
from gps_sdr.ops import cacode
from gps_sdr.ops.tracking import (init_channel_states, outs_to_numpy,
                                  reset_channel, track_chunk)
from gps_sdr.runtime.receiver import Receiver
from gps_sdr.runtime.channelmgr import select_sats
from tests.conftest import cached_synth
from tests.test_navmsg import SF1, SF2, SF3  # canonical field dicts


def _sf(sf_id, fields, tow):
    d = decode_subframe(encode_subframe(sf_id, fields, tow))
    assert d is not None
    d["ST"] = tow * 6 * 2_048_000
    d["SAT"] = 5
    return d


# -- (a) stream gap -> erase --------------------------------------------------

def test_receiver_skip_accounting_and_erase():
    cfg = ReceiverConfig()
    sat = SatSignal(prn=9, doppler=1500.0, code_delay=100.0,
                    nav_bits=random_bits(64, seed=1))
    blocks = cached_synth("recovery_skip_v1", lambda: synth_stream(
        cfg, sat and [sat], n_blocks=3 * cfg.no_sec + 1, noise_std=0.4))

    rx = Receiver(cfg)
    # skip 5 blocks before the second chunk's first block
    skips = [0] * (1 + cfg.no_sec) + [5] + [0] * (2 * cfg.no_sec)
    epochs = list(rx.run(iter(blocks), skip_iter=iter(skips)))
    assert rx.status.skipped_blocks == 5
    assert sum(e.skipped_samples for e in epochs) == 5 * cfg.ngps
    # the tracker saw the gap: stream numbers after the skip jumped, so
    # the affected chunk starts with an erase (prev_stream mismatch)
    assert rx.status.stream_no == 1 + 3 * cfg.no_sec + 5


def test_kernel_erase_on_stream_gap():
    cfg = ReceiverConfig()
    sat = SatSignal(prn=9, doppler=1500.0, code_delay=100.0,
                    nav_bits=random_bits(64, seed=1))
    blocks = cached_synth("recovery_skip_v1", lambda: synth_stream(
        cfg, [sat], n_blocks=3 * cfg.no_sec + 1, noise_std=0.4))
    states = init_channel_states(cfg, 1)
    states = reset_channel(states, 0, 9, 1500.0, 100, cfg)
    states, outs = track_chunk(cfg, states, jnp.asarray(blocks[:8]),
                               jnp.int32(1),
                               jnp.asarray(cacode.ca_table(cfg)[9][None]),
                               jnp.asarray(cacode.ca_fft_table(cfg)[9][None]))
    # continue with a gap: next chunk claims stream 20 (not 9)
    states, outs = track_chunk(cfg, states, jnp.asarray(blocks[8:16]),
                               jnp.int32(20),
                               jnp.asarray(cacode.ca_table(cfg)[9][None]),
                               jnp.asarray(cacode.ca_fft_table(cfg)[9][None]))
    outs = outs_to_numpy(outs)
    assert bool(outs.erased[0, 0])          # first block after gap erased
    assert not outs.erased[1:, 0].any()     # continuity restored after


# -- (b) signal loss -> sweep request ----------------------------------------

def test_signal_loss_triggers_sweep_request():
    # short the quality window so the test stays fast: 2 s -> 64 entries
    cfg = ReceiverConfig(corr_q_window_sec=2)
    sat = SatSignal(prn=9, doppler=1500.0, code_delay=100.0,
                    nav_bits=random_bits(64, seed=1))
    good = cached_synth("recovery_loss_good_v1", lambda: synth_stream(
        cfg, [sat], n_blocks=8, noise_std=0.4))
    rng = np.random.default_rng(3)
    noise = (0.7 * (rng.standard_normal((80, cfg.ngps))
                    + 1j * rng.standard_normal((80, cfg.ngps)))
             ).astype(np.complex64)

    code = jnp.asarray(cacode.ca_table(cfg)[9][None])
    cfft = jnp.asarray(cacode.ca_fft_table(cfg)[9][None])
    states = init_channel_states(cfg, 1)
    states = reset_channel(states, 0, 9, 1500.0, 100, cfg)
    states, outs = track_chunk(cfg, states, jnp.asarray(good),
                               jnp.int32(1), code, cfft)
    assert not outs_to_numpy(outs).sweep_request.any()
    states, outs = track_chunk(cfg, states, jnp.asarray(noise),
                               jnp.int32(9), code, cfft)
    outs = outs_to_numpy(outs)
    # once the (shortened) history fills with misses, quality < -0.9
    assert outs.sweep_request[-1, 0]
    # and the selection policy would re-acquire rather than keep it
    dels, adds = select_sats({9}, [(30.0, 12, 0.0, 5)],
                             {9: (-0.95, -1.0)}, max_sat=2)
    assert 9 in dels and 12 in adds


# -- (d) ephemeris change -> rebuild -----------------------------------------

def test_ephemeris_change_rebuilds_assembler():
    eng = PseudorangeEngine(5, ReceiverConfig())
    for sf_id, f in ((1, SF1), (2, SF2), (3, SF3)):
        assert eng.read_frame(_sf(sf_id, f, 100 + sf_id)) == SatStatus.OK
    assert eng.ephem_ok
    old_iodc = eng.ephem["IODC"]

    # new issue-of-data arrives (IODC+1 -> IODE2 mismatch)
    f2 = dict(SF2, IODE2=(SF1["IODC"] + 1) & 255)
    status = eng.read_frame(_sf(2, f2, 110))
    assert status == SatStatus.NEW_EPHEM
    # assembler rebuilt: SF2 of the new set absorbed, needs SF1/SF3 again
    assert not eng.ephem_ok
    f1 = dict(SF1, IODC=SF1["IODC"] + 1)
    f3 = dict(SF3, IODE3=(SF1["IODC"] + 1) & 255)
    eng.read_frame(_sf(1, f1, 111))
    eng.read_frame(_sf(3, f3, 112))
    assert eng.ephem_ok
    assert eng.ephem["IODC"] == old_iodc + 1


def test_ephemeris_change_invalidates_code_phase_ref():
    cfg = ReceiverConfig()
    eng = PseudorangeEngine(5, cfg)
    for sf_id, f in ((1, SF1), (2, SF2), (3, SF3)):
        eng.read_frame(_sf(sf_id, f, 100 + sf_id))
    # stream numbers just after the SF3 reference (ST = tow*6s of samples)
    sno0 = _sf(3, SF3, 103)["ST"] // cfg.ngps + 2
    eng.eval_code_phases([(sno0 + i, 1000.0) for i in range(30)])
    assert eng.ref_time is not None
    # new ephemeris set
    f2 = dict(SF2, IODE2=(SF1["IODC"] + 1) & 255)
    eng.read_frame(_sf(2, f2, 110))
    f1 = dict(SF1, IODC=SF1["IODC"] + 1)
    f3 = dict(SF3, IODE3=(SF1["IODC"] + 1) & 255)
    eng.read_frame(_sf(1, f1, 111))
    eng.read_frame(_sf(3, f3, 112))
    sno1 = _sf(3, SF3, 112)["ST"] // cfg.ngps + 2
    eng.eval_code_phases([(sno1 + i, 1000.0) for i in range(30)])
    assert eng.ref_ephem["IODC"] == SF1["IODC"] + 1


# -- (e) unhealthy SV ---------------------------------------------------------

def test_unhealthy_sv_excluded():
    asm = EphemerisAssembler(5)
    bad = dict(SF1, satHealth=1)
    st = asm.read_subframe(_sf(1, bad, 101))
    assert st == SatStatus.UNHEALTHY
    assert not asm.time_refs and not asm.ephem_ok


# -- (f) outlier gate ---------------------------------------------------------

def test_outlier_gate_with_speed_allowance():
    from gps_sdr.runtime.evaluator import Evaluator
    cfg = ReceiverConfig()          # gate 500 m + 60 m/s allowance
    ev = Evaluator(cfg)
    base = np.array([4_000_000.0, 600_000.0, 4_800_000.0])
    t0 = 1_700_000_000.0
    ev._update_stats([[t0 + 0.032 * i, *(base + i * 0.1)]
                      for i in range(10)])
    assert ev.stat is not None and len(ev.outliers) == 0
    # 10 km jump 1 s later: far outside 500 + 60 m gate
    kept = ev._update_stats([[t0 + 1.0, *(base + 10_000.0)]])
    assert kept == [] and len(ev.outliers) == 1
    # 400 m drift 10 s later: inside 500 + 600 m gate -> accepted
    kept = ev._update_stats([[t0 + 11.0, *(base + 400.0)]])
    assert len(kept) == 1
