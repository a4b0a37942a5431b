"""Multi-stream serving: S independent receivers in one device program
must produce exactly the per-stream results."""

import numpy as np
import jax
import jax.numpy as jnp

from gps_sdr.config import ReceiverConfig
from gps_sdr.models.simulator import SatSignal, random_bits, synth_stream
from gps_sdr.ops import cacode
from gps_sdr.ops.tracking import (init_channel_states, reset_channel,
                                  track_chunk_batched, track_streams)

CFG = ReceiverConfig(blocks_per_step=4)


def _stream(seed):
    rng = np.random.default_rng(seed)
    sats = [SatSignal(prn=int(p), doppler=float(rng.uniform(-4000, 4000)),
                      code_delay=float(rng.uniform(0, 2048)),
                      nav_bits=random_bits(64, seed=seed * 10 + i))
            for i, p in enumerate(rng.choice(np.arange(2, 33), 2,
                                             replace=False))]
    from tests.conftest import cached_synth
    blocks = cached_synth(f"streams_{seed}_v1", lambda: synth_stream(
        CFG, sats, 16, noise_std=0.4, seed=seed))
    states = init_channel_states(CFG, 2)
    codes = np.zeros((2, CFG.code_samples), np.float32)
    ffts = np.zeros((2, CFG.code_samples), np.complex64)
    for i, s in enumerate(sats):
        states = reset_channel(states, i, s.prn, s.doppler,
                               int(s.code_delay), CFG)
        codes[i] = cacode.ca_table(CFG)[s.prn]
        ffts[i] = cacode.ca_fft_table(CFG)[s.prn]
    return states, jnp.asarray(blocks), jnp.asarray(codes), \
        jnp.asarray(ffts)


def test_streams_match_individual_runs():
    per = [_stream(seed) for seed in (1, 2, 3)]
    refs = [track_chunk_batched(CFG, st, b, jnp.int32(1), cd, ff)
            for st, b, cd, ff in [_stream(s) for s in (1, 2, 3)]]

    states = jax.tree.map(lambda *x: jnp.stack(x), *[p[0] for p in per])
    blocks = jnp.stack([p[1] for p in per])
    codes = jnp.stack([p[2] for p in per])
    ffts = jnp.stack([p[3] for p in per])
    got_st, got = track_streams(CFG, states, blocks, jnp.int32(1),
                                codes, ffts)
    for i, (ref_st, ref) in enumerate(refs):
        np.testing.assert_allclose(np.asarray(ref.code_phase),
                                   np.asarray(got.code_phase)[i])
        np.testing.assert_allclose(np.asarray(ref.freq),
                                   np.asarray(got.freq)[i])
        np.testing.assert_array_equal(np.asarray(ref.edge_valid),
                                      np.asarray(got.edge_valid)[i])
        np.testing.assert_allclose(np.asarray(ref_st.phase),
                                   np.asarray(got_st.phase)[i])
