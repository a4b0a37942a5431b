"""The XLA heavy tracking stage (frozen-NCO Doppler mix, per-block
correlation, code-wipeoff segment sums) against a float64 numpy oracle
(chip_smoke.heavy_oracle), at a small geometry."""

import numpy as np
import jax.numpy as jnp
import pytest

from chip_smoke import heavy_oracle
from gps_sdr.config import ReceiverConfig
from gps_sdr.models.simulator import SatSignal, random_bits, synth_stream
from gps_sdr.ops import cacode
from gps_sdr.ops.tracking import (heavy_stage, init_channel_states,
                                  reset_channel)

CFG = ReceiverConfig(code_samples=256, n_cyc=8, corr_avg=4,
                     sweep_corr_avg=2, blocks_per_step=4)
SATS = [SatSignal(prn=5, doppler=987.0, code_delay=77.25,
                  nav_bits=random_bits(64, seed=5)),
        SatSignal(prn=12, doppler=-2210.0, code_delay=200.5,
                  nav_bits=random_bits(64, seed=12)),
        SatSignal(prn=23, doppler=3120.0, code_delay=12.0,
                  nav_bits=random_bits(64, seed=23))]


@pytest.mark.parametrize("n_ch", [1, 3])
def test_heavy_stage_matches_numpy_oracle(n_ch):
    k = CFG.blocks_per_step
    blocks = synth_stream(CFG, SATS, k, noise_std=0.2, seed=9)
    states = init_channel_states(CFG, n_ch)
    ffts = np.zeros((n_ch, CFG.code_samples), np.complex64)
    for i, s in enumerate(SATS[:n_ch]):
        states = reset_channel(states, i, s.prn, s.doppler,
                               int(s.code_delay), CFG)
        ffts[i] = cacode.ca_fft_table(CFG)[s.prn]
    got = heavy_stage(CFG, k, states, jnp.asarray(blocks),
                      jnp.asarray(ffts))
    for c, s in enumerate(SATS[:n_ch]):
        ref = heavy_oracle(CFG, k, s.doppler, 0.0, int(s.code_delay),
                           ffts[c], blocks)
        np.testing.assert_array_equal(np.asarray(got.delay_k)[c],
                                      ref["delay"])
        assert (ref["delay"] >= 0).sum() >= k - 1
        np.testing.assert_array_equal(np.asarray(got.wipe_delay)[c],
                                      ref["wipe"])
        np.testing.assert_allclose(np.asarray(got.code_phase_k)[c],
                                   ref["code_phase"], atol=5e-3)
        np.testing.assert_allclose(np.asarray(got.norm_max_k)[c],
                                   ref["norm"], rtol=2e-3)
        scale = np.abs(ref["seg_sums"]).max()
        # float32 oscillator angles and sums over cs samples
        assert np.abs(np.asarray(got.seg_sums_k)[c]
                      - ref["seg_sums"]).max() < 2e-3 * scale
        assert np.abs(np.asarray(got.head_k)[c]
                      - ref["head"]).max() < 2e-3 * scale
        d = np.angle(np.exp(1j * (float(np.asarray(got.phase_end)[c])
                                  - ref["phase_end"])))
        assert abs(d) < 1e-3
