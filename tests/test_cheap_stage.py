"""The K-block cheap feedback stage (ops/tracking.py channel_step_k:
means assembly, phase-rotation PLL, bit edges, correlation rings)."""

import numpy as np
import jax.numpy as jnp

from gps_sdr.config import ReceiverConfig
from gps_sdr.models.simulator import SatSignal, random_bits, synth_stream
from gps_sdr.ops import cacode
from gps_sdr.ops.tracking import (init_channel_states, outs_to_numpy,
                                  reset_channel, track_chunk_batched)

CFG = ReceiverConfig(code_samples=256, n_cyc=8, corr_avg=4,
                     sweep_corr_avg=2, blocks_per_step=4,
                     corr_q_window_sec=2)
SATS = [SatSignal(prn=5, doppler=987.0, code_delay=77.25,
                  nav_bits=random_bits(64, seed=5)),
        SatSignal(prn=12, doppler=-2210.0, code_delay=200.5,
                  nav_bits=random_bits(64, seed=12))]


def _setup(n_blocks):
    blocks = synth_stream(CFG, SATS, n_blocks, noise_std=0.2, seed=9)
    states = init_channel_states(CFG, 2)
    codes = np.zeros((2, CFG.code_samples), np.float32)
    ffts = np.zeros((2, CFG.code_samples), np.complex64)
    for i, s in enumerate(SATS):
        states = reset_channel(states, i, s.prn, s.doppler,
                               int(s.code_delay), CFG)
        codes[i] = cacode.ca_table(CFG)[s.prn]
        ffts[i] = cacode.ca_fft_table(CFG)[s.prn]
    return states, jnp.asarray(blocks), jnp.asarray(codes), \
        jnp.asarray(ffts)


def test_large_ms_time_exact():
    """ms_time past 2^24 must stay integer-exact through the K-block path.

    An f32 counter loses integer precision past 2^24 ms (~4.7 h of
    lock).  Starting the same chunk from a base past 2^24 must shift
    every edge timestamp and the carried counter by exactly that base
    (regression: hours-class serving runs silently corrupted 20 ms bit
    framing)."""
    base = 2 ** 25 + 3                     # odd offset: not f32-exact +1
    _, blocks, codes, ffts = _setup(16)

    def fresh(ms0):                        # state is donated per call
        s = _setup(16)[0]
        return s._replace(ms_time=jnp.full_like(s.ms_time, ms0))

    ref_st, ref = track_chunk_batched(CFG, fresh(0), blocks, jnp.int32(1),
                                      codes, ffts)
    got_st, got = track_chunk_batched(CFG, fresh(base), blocks,
                                      jnp.int32(1), codes, ffts)
    ro, go = outs_to_numpy(ref), outs_to_numpy(got)
    np.testing.assert_array_equal(ro.edge_valid, go.edge_valid)
    assert ro.edge_valid.any()
    np.testing.assert_array_equal(
        ro.edge_ms[ro.edge_valid].astype(np.int64) + base,
        go.edge_ms[go.edge_valid].astype(np.int64))
    np.testing.assert_array_equal(np.asarray(ref_st.ms_time) + base,
                                  np.asarray(got_st.ms_time))
    # the increment itself must be odd-exact, not rounded to even
    assert np.all((np.asarray(got_st.ms_time) - base) % 2
                  == np.asarray(ref_st.ms_time) % 2)


def test_delay_wrap_zero_mean_no_nan():
    """Code-delay wrap through 0: wipe_delay=0 leaves carry_cnt=0, so the
    next block's slot-0 mean is exactly 0+0j.  The PLL's arctan(Q/I) must
    not let the resulting 0/0 contaminate the masked sums (regression:
    freq latched to NaN after ~16 s on-chip when a channel wrapped)."""
    import functools
    import jax
    from gps_sdr.ops.tracking import HeavyOut, channel_step_k

    cfg, k = CFG, CFG.blocks_per_step
    n_ch, cs, n_cyc = 2, cfg.code_samples, cfg.n_cyc
    states = init_channel_states(cfg, n_ch)
    for i, s in enumerate(SATS):
        states = reset_channel(states, i, s.prn, s.doppler, 0, cfg)
    states = states._replace(
        locked=jnp.ones(n_ch, bool),
        std_dev=jnp.full((n_ch,), 0.05, jnp.float32),
        carry_sum=jnp.zeros(n_ch, jnp.complex64),
        carry_cnt=jnp.zeros(n_ch, jnp.int32),
        prev_stream=jnp.zeros(n_ch, jnp.int32))

    rng = np.random.default_rng(3)
    segs = (cs * 0.05 * (1.0 + 0.1 * rng.standard_normal((n_ch, k, n_cyc)))
            ).astype(np.float32) + 1j * (cs * 0.005 * rng.standard_normal(
                (n_ch, k, n_cyc))).astype(np.float32)
    heavy = HeavyOut(
        delay_k=jnp.zeros((n_ch, k), jnp.int32),
        code_phase_k=jnp.full((n_ch, k), 0.25, jnp.float32),
        norm_max_k=jnp.full((n_ch, k), 12.0, jnp.float32),
        new_delay_k=jnp.zeros((n_ch, k), jnp.int32),
        head_k=jnp.zeros((n_ch, k), jnp.complex64),
        seg_sums_k=jnp.asarray(segs, jnp.complex64),
        phase_end=jnp.zeros((n_ch,), jnp.float32),
        wipe_delay=jnp.zeros((n_ch, k), jnp.int32))

    xla = jax.vmap(functools.partial(channel_step_k, cfg, k),
                   in_axes=(0, 0, None), out_axes=0)
    st_x, out_x = xla(states, heavy, jnp.int32(1))
    assert np.isfinite(np.asarray(st_x.freq)).all()
    assert np.isfinite(np.asarray(st_x.phase)).all()
    assert np.isfinite(np.asarray(st_x.std_dev)).all()
    assert np.isfinite(np.asarray(out_x.amplitude)).all()
    # locked channels slew at most pll_max_df_per_sec/no_sec per block
    max_df = k * cfg.pll_max_df_per_sec / cfg.no_sec
    df = np.abs(np.asarray(st_x.freq)
                - np.asarray([s.doppler for s in SATS], np.float32))
    assert (df <= max_df + 1e-3).all()


def test_cheap_kernel_erase_on_gap():
    """A stream gap at a chunk boundary erases the first block's
    demodulation carry (SatStream.process skip detection) and only it."""
    st, blocks, codes, ffts = _setup(8)
    st, _ = track_chunk_batched(CFG, st, blocks[:4], jnp.int32(1),
                                codes, ffts)
    st, got = track_chunk_batched(CFG, st, blocks[4:], jnp.int32(20),
                                  codes, ffts)
    go = outs_to_numpy(got)
    assert go.erased[0].all()
    assert not go.erased[1:].any()
