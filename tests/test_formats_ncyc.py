"""Capture-format roundtrip and N_CYC=16/8 epoch configurations.

The reference supports 32/16/8 ms processing blocks (gpsglob.py:122-124)
and 8-bit packed captures (gpsrecv.py:168-172); both paths must work
here too."""

import numpy as np
import jax.numpy as jnp
import pytest

from gps_sdr.config import ReceiverConfig
from gps_sdr.models.simulator import SatSignal, random_bits, synth_stream
from gps_sdr.ops import cacode
from gps_sdr.ops.acquisition import acquire_all
from gps_sdr.ops.tracking import (init_channel_states, outs_to_numpy,
                                  reset_channel, track_chunk)
from gps_sdr.runtime.sources import pack_iq, replay_blocks, unpack_iq
from tests.conftest import cached_synth

SAT = SatSignal(prn=13, doppler=-2100.0, code_delay=512.0,
                nav_bits=random_bits(64, seed=13))


def test_pack_unpack_quantization():
    rng = np.random.default_rng(0)
    x = (0.3 * (rng.standard_normal(4096) + 1j * rng.standard_normal(4096))
         ).astype(np.complex64)
    y = unpack_iq(pack_iq(x))
    # 8-bit quantization: LSB = 2/255 per component; values saturate at
    # the rails exactly like the SDR front end
    xc = np.clip(x.real, -1, 1) + 1j * np.clip(x.imag, -1, 1)
    assert np.abs(y - xc).max() <= 1.0 / 127.5


def test_capture_replay_roundtrip(tmp_path):
    cfg = ReceiverConfig()
    # scale so the multi-sat sum stays inside the 8-bit range
    blocks = 0.25 * cached_synth("fmt_cap_v1", lambda: synth_stream(
        cfg, [SAT], n_blocks=4, noise_std=0.4, seed=2))
    path = tmp_path / "cap.bin"
    with open(path, "wb") as f:
        for b in blocks:
            pack_iq(b).tofile(f)
    got = np.stack(list(replay_blocks(str(path), cfg)))
    assert got.shape == blocks.shape
    assert np.abs(got - blocks).max() <= 1.0 / 127.5
    # the quantized capture still acquires the satellite
    found = acquire_all(cfg, got[0], cacode.ca_fft_table(cfg), prns=[13])
    assert found and found[0][1] == 13
    # START_STREAM skip
    got2 = list(replay_blocks(str(path), cfg, start_stream=2))
    assert len(got2) == 2
    np.testing.assert_array_equal(got2[0], got[2])


@pytest.mark.parametrize("n_cyc", [16, 8])
def test_tracking_other_epoch_lengths(n_cyc):
    cfg = ReceiverConfig(n_cyc=n_cyc)
    assert cfg.ngps == n_cyc * 2048 and cfg.no_sec == 1024 // n_cyc
    n_blocks = 2 * cfg.no_sec          # ~2 s
    blocks = cached_synth(f"fmt_ncyc{n_cyc}_v1", lambda: synth_stream(
        cfg, [SAT], n_blocks=n_blocks, noise_std=0.4, seed=3))

    found = acquire_all(cfg, blocks[0], cacode.ca_fft_table(cfg), prns=[13])
    assert found and found[0][1] == 13
    _, _, freq, delay = found[0]

    states = init_channel_states(cfg, 1)
    states = reset_channel(states, 0, 13, freq, delay, cfg)
    code = jnp.asarray(cacode.ca_table(cfg)[13][None])
    cfft = jnp.asarray(cacode.ca_fft_table(cfg)[13][None])
    states, outs = track_chunk(cfg, states, jnp.asarray(blocks),
                               jnp.int32(1), code, cfft)
    o = outs_to_numpy(outs)
    assert o.locked[-1, 0]
    assert (o.code_phase[:, 0] >= 0).mean() > 0.9
    assert abs(o.freq[-1, 0] - SAT.doppler) < 5.0
    # edges framed into 20 ms bits despite the shorter blocks
    assert o.edge_valid[:, 0].sum() > n_blocks // (40 // n_cyc + 1) // 4
