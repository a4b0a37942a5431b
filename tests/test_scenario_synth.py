"""Physical-scenario IQ synthesis invariants.

Regression for the chunk-boundary carrier-phase discontinuity: chunked
generation referenced each chunk's own first propagation-delay knot for
the carrier phase, which put a ~radians phase jump at every chunk
boundary — downstream this looked like a PLL half-cycle slip at block
128 of the 128-block-chunked example and corrupted the bit stream."""

import numpy as np
import pytest

from gps_sdr.config import ReceiverConfig
from gps_sdr.models.scenario import make_scenario, synth_scenario_blocks

CFG = ReceiverConfig()


@pytest.fixture(scope="module")
def scn():
    return make_scenario(CFG, n_sats=2, duration_sec=12.0, seed=3)


def test_chunked_equals_single_shot(scn):
    whole = synth_scenario_blocks(scn, 0, 4, noise_std=0.0)
    parts = np.concatenate([
        synth_scenario_blocks(scn, 0, 1, noise_std=0.0),
        synth_scenario_blocks(scn, 1, 2, noise_std=0.0),
        synth_scenario_blocks(scn, 3, 1, noise_std=0.0),
    ])
    # identical signal regardless of chunking (f32 output, tiny interp
    # differences only)
    np.testing.assert_allclose(parts, whole, atol=2e-4)


def test_noise_chunk_invariant(scn):
    whole = synth_scenario_blocks(scn, 0, 2, noise_std=0.5, seed=9)
    parts = np.concatenate([
        synth_scenario_blocks(scn, 0, 1, noise_std=0.5, seed=9),
        synth_scenario_blocks(scn, 1, 1, noise_std=0.5, seed=9),
    ])
    np.testing.assert_allclose(parts, whole, atol=2e-4)


def test_carrier_continuity_across_chunk_boundary(scn):
    """Phase step between the last sample of chunk A and the first of
    chunk B must match the within-chunk step (no boundary jump)."""
    a = synth_scenario_blocks(scn, 0, 1, noise_std=0.0)[0]
    b = synth_scenario_blocks(scn, 1, 1, noise_std=0.0)[0]
    sig = np.concatenate([a[-4:], b[:4]])
    # single dominant satellite not guaranteed -> compare the combined
    # signal directly against the unchunked one
    whole = synth_scenario_blocks(scn, 0, 2, noise_std=0.0).reshape(-1)
    np.testing.assert_allclose(sig, whole[CFG.ngps - 4:CFG.ngps + 4],
                               atol=2e-4)
