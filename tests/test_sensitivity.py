"""Sensitivity at realistic signal levels.

The other DSP tests run at easy SNR; real GPS is ~45 dB-Hz (the
reference operates on RTL-SDR captures at this level).  At amplitude 1
and per-component noise sigma, C/N0 = 10 log10(fs / (2 sigma^2)):
sigma 3.18 -> ~50 dB-Hz, 5.66 -> ~45, 8.0 -> ~42."""

import numpy as np
import jax.numpy as jnp
import pytest

from gps_sdr.config import ReceiverConfig
from gps_sdr.models.navmsg import NavDecoder
from gps_sdr.models.simulator import SatSignal, random_bits, synth_stream
from gps_sdr.ops import cacode
from gps_sdr.ops.acquisition import acquire_all
from gps_sdr.ops.tracking import (cn0_from_amp, init_channel_states,
                                  outs_to_numpy, reset_channel,
                                  track_chunk)
from tests.conftest import cached_synth

CFG = ReceiverConfig()
SAT = SatSignal(prn=9, doppler=1234.0, code_delay=800.0,
                nav_bits=random_bits(400, seed=5))


@pytest.mark.parametrize("cn0,noise", [(50, 3.18), (45, 5.66), (42, 8.0)])
def test_acquire_track_decode_at_cn0(cn0, noise):
    blocks = cached_synth(f"sens_{cn0}_v1", lambda: synth_stream(
        CFG, [SAT], 64, noise_std=noise, seed=3))

    found = acquire_all(CFG, blocks[0], cacode.ca_fft_table(CFG),
                        prns=list(range(2, 33)))
    by_prn = {f[1]: f for f in found}
    assert 9 in by_prn, f"no acquisition at {cn0} dB-Hz"
    assert len(found) == 1, f"false alarms at {cn0} dB-Hz: {found}"
    _, _, freq, delay = by_prn[9]
    assert abs(freq - SAT.doppler) <= CFG.step_freq
    assert abs(delay - SAT.code_delay) <= 1.5

    states = init_channel_states(CFG, 1)
    states = reset_channel(states, 0, 9, freq, delay, CFG)
    _, outs = track_chunk(CFG, states, jnp.asarray(blocks), jnp.int32(1),
                          jnp.asarray(cacode.ca_table(CFG)[9][None]),
                          jnp.asarray(cacode.ca_fft_table(CFG)[9][None]))
    o = outs_to_numpy(outs)
    assert o.locked[-1, 0]
    assert (o.code_phase[:, 0] >= 0).mean() > 0.7
    assert abs(o.freq[-1, 0] - SAT.doppler) < 5.0

    # C/N0 calibration: the synth's exact level is
    # 10 log10(fs / (2 sigma^2)); cn0_from_amp averaged over the
    # settled tail must land on it
    truth_cn0 = 10 * np.log10(CFG.sample_rate / (2 * noise ** 2))
    est = float(np.mean(cn0_from_amp(o.amplitude[32:, 0])))
    assert abs(est - truth_cn0) < 2.0, (est, truth_cn0)

    dec = NavDecoder(ngps=CFG.ngps)
    for b in range(blocks.shape[0]):
        dec.push_block(o.sign0[b, 0], o.edge_ms[b, 0], o.edge_local[b, 0],
                       o.edge_valid[b, 0], stream_no=1 + b,
                       erased=bool(o.erased[b, 0]))
    bits, _ = dec._frame_bits()
    assert len(bits) > 60
    ref = SAT.nav_bits.astype(np.int8)
    best = None
    for pol in (1, -1):
        g = np.asarray(bits) * pol
        for off in range(len(ref) - 48):
            if np.array_equal(ref[off:off + 48], g[:48]):
                best = (pol, off)
                break
        if best:
            break
    assert best is not None, f"bits unalignable at {cn0} dB-Hz"
    pol, off = best
    g = np.asarray(bits) * pol
    n = min(len(g), len(ref) - off)
    ber = (ref[off:off + n] != g[:n]).mean()
    assert ber == 0.0, f"BER {ber} at {cn0} dB-Hz"
