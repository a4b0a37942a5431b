"""Sharded-execution tests on the virtual 8-device CPU mesh.

Verifies that (a) grid-sharded acquisition matches the single-device
kernel bin-for-bin, and (b) time+channel-sharded tracking with full
stitching reproduces the sequential scan exactly (SURVEY.md P1/P5)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gps_sdr.config import ReceiverConfig
from gps_sdr.models.simulator import SatSignal, random_bits, synth_stream
from gps_sdr.ops import cacode
from gps_sdr.ops.acquisition import acquire
from gps_sdr.ops.tracking import (init_channel_states, reset_channel,
                                  track_chunk)
from gps_sdr.parallel import (acquire_sharded, make_mesh, pad_channels,
                              track_sharded)
from tests.conftest import cached_synth

CFG = ReceiverConfig()
SATS = [
    SatSignal(prn=5, doppler=1234.0, code_delay=300.25,
              nav_bits=random_bits(64, seed=5)),
    SatSignal(prn=12, doppler=-2750.0, code_delay=1500.5,
              nav_bits=random_bits(64, seed=12)),
    SatSignal(prn=21, doppler=3100.0, code_delay=777.0,
              nav_bits=random_bits(64, seed=21)),
    SatSignal(prn=29, doppler=-450.0, code_delay=42.0,
              nav_bits=random_bits(64, seed=29)),
]


@pytest.fixture(scope="module")
def stream8():
    return cached_synth(
        "parallel8_v1",
        lambda: synth_stream(CFG, SATS, 8, noise_std=0.5, seed=7))


def test_mesh_factorization():
    mesh = make_mesh(8)
    assert mesh.shape["time"] * mesh.shape["ch"] == 8
    mesh2 = make_mesh(8, time_shards=2)
    assert mesh2.shape["time"] == 2 and mesh2.shape["ch"] == 4


def test_acquire_sharded_matches_single(stream8):
    mesh = make_mesh(8, time_shards=2)
    block = stream8[0]
    prns = np.asarray([s.prn for s in SATS] + [7, 9])  # include absentees
    ffts = cacode.ca_fft_table(CFG)[prns]
    dop = CFG.doppler_bins.astype(np.float32)

    ref = acquire(CFG, jnp.asarray(block), jnp.asarray(dop),
                  jnp.asarray(ffts))
    got = acquire_sharded(CFG, mesh, block, dop, ffts)

    np.testing.assert_array_equal(np.asarray(ref.found), got.found)
    np.testing.assert_allclose(np.asarray(ref.norm_max), got.norm_max,
                               rtol=2e-5)
    np.testing.assert_array_equal(np.asarray(ref.delay), got.delay)
    np.testing.assert_array_equal(np.asarray(ref.freq), got.freq)


def _init_states(n_ch):
    states = init_channel_states(CFG, n_ch)
    codes = np.zeros((n_ch, CFG.code_samples), np.float32)
    ffts = np.zeros((n_ch, CFG.code_samples), np.complex64)
    tab, ftab = cacode.ca_table(CFG), cacode.ca_fft_table(CFG)
    for i, s in enumerate(SATS[:n_ch]):
        states = reset_channel(states, i, s.prn, s.doppler,
                               int(s.code_delay), CFG)
        codes[i] = tab[s.prn]
        ffts[i] = ftab[s.prn]
    return states, codes, ffts


def test_track_sharded_exact_vs_sequential(stream8):
    mesh = make_mesh(8, time_shards=2)
    states, codes, ffts = _init_states(4)
    blocks = jnp.asarray(stream8)

    ref_states, ref_outs = track_chunk(
        CFG, _init_states(4)[0], blocks, jnp.int32(1),
        jnp.asarray(codes), jnp.asarray(ffts))
    got_states, got_outs = track_sharded(
        CFG, mesh, states, blocks, jnp.int32(1), codes, ffts)

    np.testing.assert_allclose(np.asarray(ref_outs.code_phase),
                               np.asarray(got_outs.code_phase),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(ref_outs.freq),
                               np.asarray(got_outs.freq), atol=1e-3)
    np.testing.assert_array_equal(np.asarray(ref_outs.locked),
                                  np.asarray(got_outs.locked))
    np.testing.assert_array_equal(np.asarray(ref_outs.edge_valid),
                                  np.asarray(got_outs.edge_valid))
    np.testing.assert_allclose(np.asarray(ref_states.freq),
                               np.asarray(got_states.freq), atol=1e-3)
    np.testing.assert_allclose(np.asarray(ref_states.phase),
                               np.asarray(got_states.phase), atol=1e-3)


@pytest.mark.parametrize("time_shards", [1, 2, 4])
def test_track_sharded_consistent_across_shard_counts(stream8, time_shards):
    """Exact stitching must give the same answer for any shard count."""
    mesh = make_mesh(8 if time_shards > 1 else 4,
                     time_shards=time_shards)
    states, codes, ffts = _init_states(4)
    _, outs = track_sharded(CFG, mesh, states, jnp.asarray(stream8),
                            jnp.int32(1), codes, ffts)
    ref_states, ref_outs = track_chunk(
        CFG, _init_states(4)[0], jnp.asarray(stream8), jnp.int32(1),
        jnp.asarray(codes), jnp.asarray(ffts))
    np.testing.assert_allclose(np.asarray(ref_outs.code_phase),
                               np.asarray(outs.code_phase), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(ref_outs.edge_valid),
                                  np.asarray(outs.edge_valid))


def test_acquire_sharded_wide_grid(stream8):
    """BASELINE stress grid sharded over the mesh: 31 PRN x +-10 kHz."""
    mesh = make_mesh(8, time_shards=4)
    wide = CFG.replace(min_freq=-10000.0, max_freq=10000.0)
    block = stream8[0]
    prns = np.asarray(wide.prns)
    ffts = cacode.ca_fft_table(wide)[prns]
    got = acquire_sharded(wide, mesh, block,
                          wide.doppler_bins.astype(np.float32), ffts)
    found_prns = {int(prns[i]) for i in np.nonzero(got.found > 0.5)[0]}
    assert found_prns == {s.prn for s in SATS}
    for i, p in enumerate(prns):
        if int(p) in found_prns:
            truth = next(s for s in SATS if s.prn == int(p))
            assert abs(got.freq[i] - truth.doppler) <= wide.step_freq
            assert abs(got.delay[i] - truth.code_delay) <= 1.5


def test_track_sharded_warmup_handoff(stream8):
    """Boundary-state handoff (one ppermute + warmup re-scan): code
    phases must match the sequential run everywhere, and per-device
    work is (1 + W/L) scans instead of n_shards."""
    mesh = make_mesh(8, time_shards=2)
    states, codes, ffts = _init_states(4)
    blocks = jnp.asarray(stream8)
    ref_states, ref_outs = track_chunk(
        CFG, _init_states(4)[0], blocks, jnp.int32(1),
        jnp.asarray(codes), jnp.asarray(ffts))
    _, got_outs = track_sharded(CFG, mesh, states, blocks, jnp.int32(1),
                                codes, ffts, warmup_blocks=2)
    ref_cp = np.asarray(ref_outs.code_phase)
    got_cp = np.asarray(got_outs.code_phase)
    both = (ref_cp >= 0) & (got_cp >= 0)
    assert (np.abs(ref_cp - got_cp)[both] < 0.5).mean() > 0.95
    # the warmup window itself is corrected: shard 1's first blocks use
    # the handed-off exact state, so they match the sequential run
    np.testing.assert_allclose(ref_cp[4:6][both[4:6]],
                               got_cp[4:6][both[4:6]], atol=1e-3)


def test_track_sharded_approximate_stitch(stream8):
    """n_stitch < n_shards: later time shards start from a k-hop state;
    tracking must still lock and code phases must match the sequential
    run away from shard boundaries (the boundary transient is bounded
    by the PLL re-lock time)."""
    mesh = make_mesh(8, time_shards=4)
    states, codes, ffts = _init_states(4)
    blocks = jnp.asarray(stream8)
    ref_states, ref_outs = track_chunk(
        CFG, _init_states(4)[0], blocks, jnp.int32(1),
        jnp.asarray(codes), jnp.asarray(ffts))
    _, got_outs = track_sharded(CFG, mesh, states, blocks, jnp.int32(1),
                                codes, ffts, n_stitch=2)
    ref_cp = np.asarray(ref_outs.code_phase)
    got_cp = np.asarray(got_outs.code_phase)
    both = (ref_cp >= 0) & (got_cp >= 0)
    # correlation-derived measurements are feedback-light: equal nearly
    # everywhere even with a 2-pass stitch
    close = np.abs(ref_cp - got_cp)[both] < 0.5
    assert close.mean() > 0.9
    # NOTE: lock flags are NOT asserted here — with 2-block shards the
    # PLL re-lock transient spans a whole shard; production shards are
    # thousands of blocks where the transient is negligible.


def test_track_sharded_channel_padding(stream8):
    mesh = make_mesh(8, time_shards=2)  # ch axis = 4
    states, codes, ffts = _init_states(3)  # 3 channels -> pad to 4
    states, codes, ffts = pad_channels(states, codes, ffts,
                                       mesh.shape["ch"])
    assert np.asarray(states.prn).shape[0] == 4
    _, outs = track_sharded(CFG, mesh, states, jnp.asarray(stream8),
                            jnp.int32(1), codes, ffts)
    cp = np.asarray(outs.code_phase)
    assert cp.shape[1] == 4
    assert np.all(cp[:, 3] == -1.0)  # padded slot stays inactive
    assert (cp[:, :3] >= 0).mean() >= 0.75  # real channels keep finding peaks
