"""Device-side synthesizer equivalence vs the numpy oracle.

sim_jax trades the oracle's exact per-sample float64 interpolation for
f32 block-relative arithmetic (and a slice-select code/bit lookup that
avoids per-sample gathers); this
pins the two implementations together."""

import numpy as np
import jax
import pytest

from gps_sdr.config import ReceiverConfig
from gps_sdr.models.sim_jax import JaxSynth
from gps_sdr.models.simulator import (SatSignal, random_bits,
                                      synth_stream_chunk)

CFG = ReceiverConfig()


def _sats():
    return [
        SatSignal(prn=9, doppler=3211.0, code_delay=731.6, amplitude=1.1,
                  carrier_phase=0.8, nav_bits=random_bits(256, seed=9)),
        SatSignal(prn=17, doppler=-4790.0, code_delay=2047.2,
                  amplitude=0.8, nav_bits=random_bits(256, seed=17)),
        # near-zero drift: exercises the no-drift-step path
        SatSignal(prn=21, doppler=10.0, code_delay=0.4,
                  nav_bits=random_bits(256, seed=21)),
    ]


@pytest.mark.parametrize("first_block", [0, 7, 200])
def test_matches_numpy_simulator(first_block):
    sats = _sats()
    ref = synth_stream_chunk(CFG, sats, first_block, 2, noise_std=0.0)
    synth = JaxSynth(CFG, sats, noise_std=0.0)
    got = np.asarray(synth.chunk(first_block, 2))
    # f32 positions vs f64: tiny code-phase rounding at chip transitions
    err = np.abs(got - ref)
    assert np.quantile(err, 0.999) < 6e-3
    assert err.mean() < 1e-3


def test_chunk_continuity():
    sats = _sats()
    synth = JaxSynth(CFG, sats, noise_std=0.0)
    whole = np.asarray(synth.chunk(3, 2))
    parts = np.concatenate([np.asarray(synth.chunk(3, 1)),
                            np.asarray(synth.chunk(4, 1))])
    np.testing.assert_allclose(parts, whole, atol=1e-5)


def test_noise_deterministic_by_block():
    sats = _sats()
    synth = JaxSynth(CFG, sats, noise_std=0.5, seed=4)
    a = np.asarray(synth.chunk(2, 2))
    b = np.asarray(synth.chunk(2, 2))
    np.testing.assert_array_equal(a, b)


def test_planar_layout_matches_complex():
    sats = _sats()
    synth = JaxSynth(CFG, sats, noise_std=0.3, seed=9)
    # grouped planar [T, 2, n_cyc, cs]: the canonical device chunk
    # layout (tiles straight into the Pallas tracking kernel)
    planar = np.asarray(synth.chunk_planar(1, 2))
    cplx = np.asarray(synth.chunk(1, 2))            # [T, ngps] c64
    assert planar.shape == (2, 2, CFG.n_cyc, CFG.code_samples)
    assert planar.dtype == np.float32
    flat = planar.reshape(2, 2, CFG.ngps)
    np.testing.assert_array_equal(flat[:, 0], cplx.real)
    np.testing.assert_array_equal(flat[:, 1], cplx.imag)
