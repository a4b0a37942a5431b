"""Closed-loop tracking tests on synthetic IQ with known ground truth."""

import jax.numpy as jnp
import numpy as np
import pytest

from gps_sdr.config import DEFAULT as CFG, L1_FREQ
from gps_sdr.models import navmsg
from gps_sdr.models.simulator import SatSignal, random_bits, synth_stream
from gps_sdr.ops import cacode
from gps_sdr.ops.acquisition import acquire_all
from gps_sdr.ops.tracking import init_channel_states, outs_to_numpy, \
    reset_channel, track_chunk

N_CH = 4


def _run(sats, n_sec, noise=0.7, seed=7):
    """Acquire on block 0, then track chunk-by-chunk. Returns per-channel
    histories and final states."""
    from conftest import cached_synth
    key = f"track:{[(s.prn, s.doppler, s.code_delay, s.amplitude, s.nav_bits.tobytes().hex()) for s in sats]}:{n_sec}:{noise}:{seed}"
    blocks = cached_synth(key, lambda: synth_stream(
        CFG, sats, n_blocks=n_sec * CFG.no_sec, noise_std=noise, seed=seed))
    codes_tab = cacode.ca_table(CFG)
    ffts_tab = cacode.ca_fft_table(CFG)
    found = acquire_all(CFG, blocks[0], ffts_tab)
    by_prn = {prn: (freq, delay) for _, prn, freq, delay in found}
    assert set(by_prn) >= {s.prn for s in sats}

    states = init_channel_states(CFG, N_CH)
    codes = np.zeros((N_CH, CFG.code_samples), np.float32)
    ffts = np.zeros((N_CH, CFG.code_samples), np.complex64)
    decoders = []
    for i, s in enumerate(sats):
        freq, delay = by_prn[s.prn]
        states = reset_channel(states, i, s.prn, freq, delay, CFG)
        codes[i] = codes_tab[s.prn]
        ffts[i] = ffts_tab[s.prn]
        decoders.append(navmsg.NavDecoder(ngps=CFG.ngps))

    codes, ffts = jnp.asarray(codes), jnp.asarray(ffts)
    hist = {"code_phase": [], "freq": [], "locked": [], "amplitude": []}
    t = CFG.no_sec
    for sec in range(n_sec):
        chunk = jnp.asarray(blocks[sec * t:(sec + 1) * t])
        states, outs = track_chunk(CFG, states, chunk,
                                   jnp.int32(1 + sec * t), codes, ffts)
        outs = outs_to_numpy(outs)
        for key in hist:
            hist[key].append(getattr(outs, key))
        for blk in range(t):
            for i in range(len(sats)):
                decoders[i].push_block(
                    outs.sign0[blk, i], outs.edge_ms[blk, i],
                    outs.edge_local[blk, i], outs.edge_valid[blk, i],
                    stream_no=1 + sec * t + blk,
                    erased=bool(outs.erased[blk, i]))
    hist = {k: np.concatenate(v, axis=0) for k, v in hist.items()}
    return hist, states, decoders, by_prn


import jax  # noqa: E402  (after conftest platform setup)


def test_single_channel_lock_and_bits():
    bits = random_bits(400, seed=5)
    truth = SatSignal(prn=9, doppler=2345.0, code_delay=800.0,
                      amplitude=1.0, nav_bits=bits)
    hist, states, decoders, by_prn = _run([truth], n_sec=2)

    # PLL locks and pulls the Doppler estimate to the true value
    assert bool(np.asarray(states.locked)[0])
    assert abs(float(np.asarray(states.freq)[0]) - truth.doppler) < 2.0
    # correlation peak found in every block, code phase near ground truth
    cp = hist["code_phase"][:, 0]
    assert np.all(cp >= 0)
    t_blocks = np.arange(len(cp)) * CFG.block_sec
    # ground truth evaluated at the center of each block (where the
    # correlation is measured)
    t_meas = t_blocks + CFG.block_sec / 2
    cp_true = (truth.code_delay
               + truth.delay_rate(CFG) * t_meas) % CFG.code_samples
    err = (cp - cp_true + 1024) % 2048 - 1024
    assert np.max(np.abs(err)) < 0.5
    # signal amplitude significance is high on a clean signal
    assert np.mean(hist["amplitude"][CFG.no_sec:, 0]) > 3

    # nav bits recovered from edge events
    nb, _ = decoders[0]._frame_bits()
    rec = np.asarray(nb, np.int8)
    assert len(rec) > 40
    # locate rec inside the injected bit sequence (sign may be inverted)
    injected = bits.astype(np.int32)
    got = rec.astype(np.int32)
    corr = np.correlate(injected, got, mode="valid")
    assert np.max(np.abs(corr)) == len(got)


def test_multi_channel_independent_tracking():
    sats = [
        SatSignal(prn=3, doppler=-4100.0, code_delay=33.0, amplitude=0.9,
                  nav_bits=random_bits(300, seed=1)),
        SatSignal(prn=17, doppler=150.0, code_delay=1999.0, amplitude=1.1,
                  nav_bits=random_bits(300, seed=2)),
        SatSignal(prn=28, doppler=4900.0, code_delay=1024.0, amplitude=0.8,
                  nav_bits=random_bits(300, seed=3)),
    ]
    hist, states, _, _ = _run(sats, n_sec=2, noise=0.8)
    locked = np.asarray(states.locked)
    freqs = np.asarray(states.freq)
    for i, s in enumerate(sats):
        assert bool(locked[i]), f"channel {i} failed to lock"
        assert abs(freqs[i] - s.doppler) < 3.0
    # inactive slot untouched
    assert not bool(locked[3])
    assert np.all(hist["code_phase"][:, 3] == -1.0)


def test_stream_skip_triggers_erase():
    truth = SatSignal(prn=9, doppler=1000.0, code_delay=100.0,
                      nav_bits=random_bits(64, seed=4))
    blocks = synth_stream(CFG, [truth], n_blocks=2, noise_std=0.5)
    states = init_channel_states(CFG, 1)
    states = reset_channel(states, 0, 9, 1000.0, 100, CFG)
    codes = jnp.asarray(cacode.ca_table(CFG)[9:10])
    ffts = jnp.asarray(cacode.ca_fft_table(CFG)[9:10])
    states, o1 = track_chunk(CFG, states, jnp.asarray(blocks[:1]),
                             jnp.int32(1), codes, ffts)
    assert not bool(np.asarray(o1.erased)[0, 0])
    # jump the stream number by 3 -> skip detected, carry erased
    states, o2 = track_chunk(CFG, states, jnp.asarray(blocks[1:]),
                             jnp.int32(5), codes, ffts)
    assert bool(np.asarray(o2.erased)[0, 0])
