"""Compact device->host transport (pack_outs_compact) correctness.

The streaming receiver's steady-state cost is the per-chunk output
download (a fixed per-transfer cost + bandwidth); run_device ships a
sparse edge/summary buffer instead of the dense [T, C, 4*(n_cyc+1)+11]
planes and batches several chunks per transfer.  These tests pin that
the compact path is bit-exact where the host consumes it (reference
behavior surface: gpsrecv.py:445-548 result collection).
"""

import numpy as np
import jax.numpy as jnp

from gps_sdr.config import ReceiverConfig
from gps_sdr.models.simulator import SatSignal, random_bits
from gps_sdr.models.sim_jax import JaxSynth
from gps_sdr.ops import cacode
from gps_sdr.ops.tracking import (init_channel_states, outs_to_numpy,
                                  pack_outs_compact, reset_channel,
                                  to_f32_pairs, track_chunk_batched,
                                  unpack_outs_compact)
from gps_sdr.runtime.receiver import Receiver

CFG = ReceiverConfig(code_samples=256, n_cyc=8, corr_avg=4,
                     sweep_corr_avg=2, blocks_per_step=4,
                     corr_q_window_sec=2)
SATS = [SatSignal(prn=5, doppler=987.0, code_delay=77.25,
                  nav_bits=random_bits(512, seed=5)),
        SatSignal(prn=12, doppler=-2210.0, code_delay=200.5,
                  nav_bits=random_bits(512, seed=12))]


def _tracked_outs(n_blocks=16):
    from gps_sdr.models.simulator import synth_stream
    blocks = synth_stream(CFG, SATS, n_blocks, noise_std=0.2, seed=9)
    states = init_channel_states(CFG, 2)
    codes = np.zeros((2, CFG.code_samples), np.float32)
    ffts = np.zeros((2, CFG.code_samples), np.complex64)
    for i, s in enumerate(SATS):
        states = reset_channel(states, i, s.prn, s.doppler,
                               int(s.code_delay), CFG)
        codes[i] = cacode.ca_table(CFG)[s.prn]
        ffts[i] = cacode.ca_fft_table(CFG)[s.prn]
    _, outs = track_chunk_batched(CFG, states, jnp.asarray(blocks),
                                  jnp.int32(1), jnp.asarray(codes),
                                  jnp.asarray(ffts))
    return outs


def test_compact_roundtrip_matches_dense():
    outs = _tracked_outs()
    dense = outs_to_numpy(outs)
    t, c, sl = dense.edge_valid.shape
    cap = 64
    buf = np.asarray(pack_outs_compact(outs, cap))
    got, dropped = unpack_outs_compact(buf, t, c, sl, cap)
    assert dropped.sum() == 0
    # exact on everything the consume path reads
    np.testing.assert_array_equal(dense.code_phase, got.code_phase)
    np.testing.assert_array_equal(dense.sign0, got.sign0)
    np.testing.assert_array_equal(dense.erased, got.erased)
    np.testing.assert_array_equal(dense.edge_valid, got.edge_valid)
    np.testing.assert_array_equal(dense.edge_ms[dense.edge_valid],
                                  got.edge_ms[got.edge_valid])
    np.testing.assert_array_equal(dense.edge_local[dense.edge_valid],
                                  got.edge_local[got.edge_valid])
    for name in ("amplitude", "corr_q", "corr_l", "freq", "norm_max"):
        np.testing.assert_array_equal(getattr(dense, name)[-1],
                                      getattr(got, name)[-1])
    np.testing.assert_array_equal(dense.locked[-1], got.locked[-1])
    np.testing.assert_array_equal(dense.sweep_request[-1],
                                  got.sweep_request[-1])


def test_compact_overflow_counts_drops():
    outs = _tracked_outs()
    dense = outs_to_numpy(outs)
    t, c, sl = dense.edge_valid.shape
    n_edges = dense.edge_valid.sum(axis=(0, 2))          # per channel
    cap = max(1, int(n_edges.max()) - 2)                 # force overflow
    buf = np.asarray(pack_outs_compact(outs, cap))
    got, dropped = unpack_outs_compact(buf, t, c, sl, cap)
    np.testing.assert_array_equal(dropped, np.maximum(n_edges - cap, 0))
    # surviving edges are the earliest ones, in order
    for ch in range(c):
        want = np.argwhere(dense.edge_valid[:, ch, :])
        got_e = np.argwhere(got.edge_valid[:, ch, :])
        np.testing.assert_array_equal(got_e, want[:cap])


def _primed_receiver(cfg, sats):
    r = Receiver(cfg)
    r.sweep_all = False
    for s in sats:
        r._activate(s.prn, s.doppler, int(s.code_delay) % cfg.code_samples)
    r._refresh_code_tables()
    return r


def _frames_key(epochs):
    return [(e.skipped_samples,
             [sorted(f.items()) for f in e.frames],
             sorted(e.code_phases.items())) for e in epochs]


def test_run_device_batched_matches_run():
    """run_device (compact transport, 3-chunk batched downloads) must
    yield the same epoch stream as the dense host path run()."""
    cfg = CFG.replace(max_sat=2, chunks_per_download=3)
    sats = SATS
    n_chunks = 3
    t = 24                      # chunk_blocks (<< no_sec: fast test)
    synth = JaxSynth(cfg, sats, noise_std=0.2, seed=9)

    rd = _primed_receiver(cfg, sats)
    dev_epochs = list(rd.run_device(synth.chunk_planar, n_chunks,
                                    chunk_blocks=t))

    rh = _primed_receiver(cfg, sats)
    host_blocks = [np.asarray(synth.chunk(ci * t, t)) for ci in
                   range(n_chunks)]
    host_epochs = []
    for ci, blocks in enumerate(host_blocks):
        rh.status.stream_no = ci * t
        chunk = [blocks[i] for i in range(t)]
        host_epochs.append(rh._run_chunk(chunk, 0)[0])

    assert rd.status.edge_overflows == 0
    assert _frames_key(dev_epochs) == _frames_key(host_epochs)


def test_run_device_overlapped_windows_identical():
    """download_windows_in_flight=2 (host consume of window k overlaps
    device compute of window k+1) must yield the identical epoch
    stream — only latency changes, never content."""
    sats = SATS
    n_chunks = 4
    t = 24
    epochs = {}
    for wif in (1, 2):
        cfg = CFG.replace(max_sat=2, chunks_per_download=2,
                          download_windows_in_flight=wif)
        synth = JaxSynth(cfg, sats, noise_std=0.2, seed=9)
        r = _primed_receiver(cfg, sats)
        epochs[wif] = list(r.run_device(synth.chunk_planar, n_chunks,
                                        chunk_blocks=t))
        assert r.status.edge_overflows == 0
    assert _frames_key(epochs[1]) == _frames_key(epochs[2])


def test_defer_subframe_poll_window_equivalent():
    """defer_subframe_poll=True polls decoders once per download window;
    per-chunk epochs differ only in WHICH epoch carries a decoded
    subframe — merged per window (evaluator.merge_epochs, the throughput
    pairing) the streams are identical."""
    from gps_sdr.runtime.evaluator import merge_epochs

    sats = SATS
    n_chunks = 6
    w = 3
    t = 24
    runs = {}
    for defer in (False, True):
        cfg = CFG.replace(max_sat=2, chunks_per_download=w,
                          defer_subframe_poll=defer)
        synth = JaxSynth(cfg, sats, noise_std=0.2, seed=9)
        r = _primed_receiver(cfg, sats)
        eps = list(r.run_device(synth.chunk_planar, n_chunks,
                                chunk_blocks=t))
        assert len(eps) == n_chunks
        merged = [merge_epochs(eps[i:i + w])
                  for i in range(0, n_chunks, w)]
        runs[defer] = (eps, merged)

    # code phases are poll-independent: identical per chunk
    for ea, eb in zip(runs[False][0], runs[True][0]):
        assert sorted(ea.code_phases.items()) == \
            sorted(eb.code_phases.items())
    # frames match once merged per window (order-normalized)
    def key(eps):
        return [[sorted((k, str(v)) for k, v in f.items())
                 for f in sorted(e.frames, key=str)] for e in eps]
    assert key(runs[False][1]) == key(runs[True][1])
    # full-subframe delivery under defer_subframe_poll is covered end
    # to end by the serving-with-fixes bench (fixes require decoded
    # ephemerides); this fixture is too short for a 6 s subframe

    # epoch_per_window: ONE epoch per window, its code phases equal the
    # merged per-chunk stream; report frames come from the window's
    # last chunk
    cfg = CFG.replace(max_sat=2, chunks_per_download=w,
                      epoch_per_window=True)
    synth = JaxSynth(cfg, sats, noise_std=0.2, seed=9)
    r = _primed_receiver(cfg, sats)
    win_eps = list(r.run_device(synth.chunk_planar, n_chunks,
                                chunk_blocks=t))
    assert len(win_eps) == n_chunks // w
    for k, we in enumerate(win_eps):
        assert sorted(we.code_phases.items()) == \
            sorted(runs[False][1][k].code_phases.items())
        last = runs[False][0][k * w + w - 1]
        assert key([we]) == key([last])


def test_run_device_fused_window_identical():
    """fused_window_dispatch=True (track_window: one device program per
    download window) must yield the identical epoch stream as the
    per-chunk dispatch loop, including the partial per-chunk tail when
    n_chunks is not divisible by the window."""
    sats = SATS
    n_chunks = 5                    # 2 fused windows + 1 tail chunk
    t = 24
    epochs = {}
    for fused in (False, True):
        cfg = CFG.replace(max_sat=2, chunks_per_download=2,
                          download_windows_in_flight=2,
                          fused_window_dispatch=fused)
        synth = JaxSynth(cfg, sats, noise_std=0.2, seed=9)
        r = _primed_receiver(cfg, sats)
        epochs[fused] = list(r.run_device(synth.chunk_planar, n_chunks,
                                          chunk_blocks=t))
        assert r.status.edge_overflows == 0
    assert _frames_key(epochs[True]) == _frames_key(epochs[False])
