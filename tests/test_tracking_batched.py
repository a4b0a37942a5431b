"""K-block fused tracking step vs the sequential per-block step.

The fused step freezes the mixer NCO within a step and applies PLL
phase corrections as rotations on the per-ms means (ops/tracking.py,
channel_step_k).  Post-lock it must track the same signal with the same
code phases, frequency, and decoded bit edges as the sequential form;
intra-step NCO mistuning is bounded by the slew limit and must not
change decoded bits."""

import numpy as np
import jax.numpy as jnp
import pytest

from gps_sdr.config import ReceiverConfig
from gps_sdr.models.navmsg import NavDecoder
from gps_sdr.models.simulator import SatSignal, random_bits, synth_stream
from gps_sdr.ops import cacode
from gps_sdr.ops.tracking import (init_channel_states, outs_to_numpy,
                                  reset_channel, track_chunk,
                                  track_chunk_batched)

CFG = ReceiverConfig()
SATS = [
    SatSignal(prn=5, doppler=1234.0, code_delay=300.25,
              nav_bits=random_bits(128, seed=5)),
    SatSignal(prn=21, doppler=-3100.0, code_delay=777.0,
              nav_bits=random_bits(128, seed=21)),
]


@pytest.fixture(scope="module")
def stream():
    from tests.conftest import cached_synth
    return cached_synth(
        "batched_track_v1",
        lambda: synth_stream(CFG, SATS, 96, noise_std=0.4, seed=11))


def _states():
    states = init_channel_states(CFG, 2)
    codes = np.zeros((2, CFG.code_samples), np.float32)
    ffts = np.zeros((2, CFG.code_samples), np.complex64)
    for i, s in enumerate(SATS):
        states = reset_channel(states, i, s.prn, s.doppler,
                               int(s.code_delay), CFG)
        codes[i] = cacode.ca_table(CFG)[s.prn]
        ffts[i] = cacode.ca_fft_table(CFG)[s.prn]
    return states, jnp.asarray(codes), jnp.asarray(ffts)


def _decode_bits(outs, n_blocks):
    o = outs_to_numpy(outs)
    bits = []
    for c in range(2):
        dec = NavDecoder(ngps=CFG.ngps)
        got = []
        for b in range(n_blocks):
            dec.push_block(o.sign0[b, c], o.edge_ms[b, c],
                           o.edge_local[b, c], o.edge_valid[b, c],
                           stream_no=1 + b, erased=bool(o.erased[b, c]))
        nb, _ = dec._frame_bits()
        got.append(nb)
        bits.append(np.concatenate(got))
    return bits, o


def test_k1_equals_sequential(stream):
    blocks = jnp.asarray(stream[:32])
    st, codes, ffts = _states()
    ref_st, ref = track_chunk(CFG, st, blocks, jnp.int32(1), codes, ffts)
    cfg1 = CFG.replace(blocks_per_step=1)
    st, _, _ = _states()[0], None, None
    st2, codes, ffts = _states()
    got_st, got = track_chunk_batched(cfg1, st2, blocks, jnp.int32(1),
                                      codes, ffts)
    np.testing.assert_allclose(np.asarray(ref.code_phase),
                               np.asarray(got.code_phase))
    np.testing.assert_allclose(np.asarray(ref.freq), np.asarray(got.freq))


@pytest.mark.parametrize("k", [4, 8, 16, 32])
def test_batched_tracks_like_sequential(stream, k):
    """Any K: the virtual intra-step NCO retune + per-block predicted
    wipeoff delays (ops/tracking.py channel_step_k, predict_wipe_delays)
    keep the fused step sequential-equivalent — same lock, frequency,
    code phases, and decoded bits at K = 4 through 32."""
    blocks = jnp.asarray(stream)
    n = stream.shape[0]
    st, codes, ffts = _states()
    ref_st, ref = track_chunk(CFG, st, blocks, jnp.int32(1), codes, ffts)
    cfgk = CFG.replace(blocks_per_step=k)
    st2, codes, ffts = _states()
    got_st, got = track_chunk_batched(cfgk, st2, blocks, jnp.int32(1),
                                      codes, ffts)

    ref_bits, ro = _decode_bits(ref, n)
    got_bits, go = _decode_bits(got, n)
    for c in range(2):
        # both lock and settle on the true Doppler
        assert go.locked[-1, c] and ro.locked[-1, c]
        assert abs(go.freq[-1, c] - SATS[c].doppler) < 3.0
        # identical code phases wherever both found the peak
        both = (ro.code_phase[:, c] >= 0) & (go.code_phase[:, c] >= 0)
        assert both.mean() > 0.9
        np.testing.assert_allclose(ro.code_phase[both, c],
                                   go.code_phase[both, c], atol=0.2)
        # identical decoded bit streams post-lock (allow edge-of-stream
        # length differences)
        a, b = ref_bits[c], got_bits[c]
        m = min(len(a), len(b))
        assert m > 100
        assert (a[:m] == b[:m]).mean() > 0.99


@pytest.mark.parametrize("k", [8, 32])
def test_fresh_channel_pull_in(stream, k):
    """A freshly reset channel with an acquisition-grid frequency error
    (~100 Hz) must pull in like the sequential loop.  Regression: the
    fused step froze the NCO for the whole step, every block measured
    the SAME error, and the summed df corrections overshot Kx (-827 Hz
    at K=8) — the virtual intra-step NCO retune fixes it."""
    blocks = jnp.asarray(stream)[:64]
    st, codes, ffts = _states()
    # 100 Hz off true, like a 200 Hz acquisition grid would deliver
    st = reset_channel(st, 0, SATS[0].prn, SATS[0].doppler + 100.0,
                       int(SATS[0].code_delay), CFG)
    cfgk = CFG.replace(blocks_per_step=k)
    st2, got = track_chunk_batched(cfgk, st, blocks, jnp.int32(1),
                                   codes, ffts)
    go = outs_to_numpy(got)
    # locked within the first second and frequency within 3 Hz of true
    assert go.locked[40:, 0].all()
    assert abs(float(np.asarray(st2.freq)[0]) - SATS[0].doppler) < 3.0
    # the correlator never loses the peak for long
    assert (go.code_phase[8:, 0] >= 0).mean() > 0.8


def test_batched_remainder_tail(stream):
    """T not divisible by K: fused prefix + sequential tail must equal
    one batched run over the full divisible stream state-for-state
    (partial final chunks / skip-forced boundaries in the receiver)."""
    k = 8
    cfgk = CFG.replace(blocks_per_step=k)
    blocks = jnp.asarray(stream)
    t = 92                      # 11*8 + 4 tail
    st, codes, ffts = _states()
    st_ref, ref = track_chunk(CFG, st, blocks[:t], jnp.int32(1), codes,
                              ffts)
    st2, codes, ffts = _states()
    st_got, got = track_chunk_batched(cfgk, st2, blocks[:t],
                                      jnp.int32(1), codes, ffts)
    assert np.asarray(got.code_phase).shape[0] == t
    ro, go = outs_to_numpy(ref), outs_to_numpy(got)
    # same lock and same frequency at the end; tail outputs present
    np.testing.assert_array_equal(np.asarray(st_ref.locked),
                                  np.asarray(st_got.locked))
    np.testing.assert_allclose(np.asarray(st_ref.freq),
                               np.asarray(st_got.freq), atol=1.0)
    both = (ro.code_phase[-4:] >= 0) & (go.code_phase[-4:] >= 0)
    np.testing.assert_allclose(ro.code_phase[-4:][both],
                               go.code_phase[-4:][both], atol=0.2)


def test_planar_input_equals_complex():
    """Planar f32[T, 2, ngps] IQ must produce the same results as c64
    blocks through the K-block path (small config)."""
    from gps_sdr.ops.tracking import reset_channel as _reset

    cfg_s = ReceiverConfig(code_samples=256, n_cyc=8, corr_avg=4,
                           sweep_corr_avg=2, blocks_per_step=4)
    sats_s = [SatSignal(prn=5, doppler=987.0, code_delay=77.25,
                        nav_bits=random_bits(64, seed=5)),
              SatSignal(prn=12, doppler=-2210.0, code_delay=200.5,
                        nav_bits=random_bits(64, seed=12))]
    blocks_c = jnp.asarray(synth_stream(cfg_s, sats_s, 16, noise_std=0.2,
                                        seed=9))
    planar = jnp.stack([jnp.real(blocks_c), jnp.imag(blocks_c)], axis=1)

    def states_s():
        st = init_channel_states(cfg_s, 2)
        codes = np.zeros((2, cfg_s.code_samples), np.float32)
        ffts = np.zeros((2, cfg_s.code_samples), np.complex64)
        for i, s in enumerate(sats_s):
            st = _reset(st, i, s.prn, s.doppler, int(s.code_delay), cfg_s)
            codes[i] = cacode.ca_table(cfg_s)[s.prn]
            ffts[i] = cacode.ca_fft_table(cfg_s)[s.prn]
        return st, jnp.asarray(codes), jnp.asarray(ffts)

    cfgk = cfg_s
    st, codes, ffts = states_s()
    ref_st, ref = track_chunk_batched(cfgk, st, blocks_c,
                                      jnp.int32(1), codes, ffts)
    st2, codes, ffts = states_s()
    got_st, got = track_chunk_batched(cfgk, st2, planar,
                                      jnp.int32(1), codes, ffts)
    np.testing.assert_allclose(np.asarray(ref.code_phase),
                               np.asarray(got.code_phase), atol=1e-5)
    np.testing.assert_allclose(np.asarray(ref.amplitude),
                               np.asarray(got.amplitude), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(ref_st.freq),
                               np.asarray(got_st.freq), atol=1e-4)
