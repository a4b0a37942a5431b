"""Channel-set elasticity at the receiver level.

The reference keeps the satellite set elastic at sweep boundaries:
channels whose 60 s quality collapses are dropped and freed slots are
refilled from acquisition in correlation order (getNewSats,
gpsrecv.py:423-440).  Simulate a satellite vanishing mid-run and a new
one rising; a requested sweep must swap the channel set accordingly."""

import numpy as np

from gps_sdr.config import ReceiverConfig
from gps_sdr.models.simulator import SatSignal, random_bits, synth_stream
from gps_sdr.runtime.receiver import Receiver
from tests.conftest import cached_synth

CFG = ReceiverConfig(max_sat=2, corr_q_window_sec=2)

SAT_A = SatSignal(prn=5, doppler=1500.0, code_delay=300.0,
                  nav_bits=random_bits(64, seed=5))
SAT_B = SatSignal(prn=12, doppler=-2200.0, code_delay=900.0,
                  nav_bits=random_bits(64, seed=12))
SAT_C = SatSignal(prn=23, doppler=3100.0, code_delay=1500.0,
                  nav_bits=random_bits(64, seed=23))


def _phase_stream():
    """Blocks 0..2N: A+B first, then B+C (A sets, C rises)."""
    n = 3 * CFG.no_sec
    ab = cached_synth("elastic_ab_v1", lambda: synth_stream(
        CFG, [SAT_A, SAT_B], n, noise_std=0.4, seed=1))
    bc = cached_synth("elastic_bc_v1", lambda: synth_stream(
        CFG, [SAT_B, SAT_C], n, noise_std=0.4, seed=2))
    return np.concatenate([ab, bc])


def test_sweep_replaces_set_satellite():
    blocks = _phase_stream()
    rx = Receiver(CFG)
    n_half = 3 * CFG.no_sec

    epochs = []
    gen = rx.run(iter(blocks))
    for i, epoch in enumerate(gen):
        epochs.append(epoch)
        # after the handover, A's quality collapses within the 2 s
        # window; request a global re-sweep (GUI Sweep button /
        # automatic policy)
        if rx.status.blocks_processed >= n_half + 2 * CFG.no_sec \
                and 5 in rx.slots.active:
            rx.request_sweep()
    # cold start picked A and B
    assert {5, 12} <= {sf["SAT"] for e in epochs[:2] for sf in e.frames}
    # after the sweep the set is B + C; A is gone
    assert rx.slots.active == {12, 23}
    # the new channel produces code phases
    last = epochs[-1]
    assert 23 in last.code_phases and len(last.code_phases[23]) > 20
    assert 12 in last.code_phases
