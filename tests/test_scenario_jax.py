"""Device-side scenario synthesis vs the float64 numpy oracle."""

import numpy as np
import pytest

from gps_sdr.config import ReceiverConfig
from gps_sdr.models.scenario import make_scenario, synth_scenario_blocks
from gps_sdr.models.scenario_jax import DeviceScenarioSynth

CFG = ReceiverConfig()


@pytest.fixture(scope="module")
def scn():
    return make_scenario(CFG, n_sats=3, duration_sec=12.0, seed=3)


def test_matches_numpy_oracle(scn):
    ref = synth_scenario_blocks(scn, 0, 2, noise_std=0.0)
    dev = DeviceScenarioSynth(scn, noise_std=0.0)
    got = np.asarray(dev.chunk(0, 2))
    err = np.abs(got - ref)
    # f32 interpolation differences only; the oracle itself commits
    # ~1e-3-scale interp error at chip transitions
    assert np.quantile(err, 0.999) < 2e-2
    assert err.mean() < 2e-3


def test_chunk_offset_matches(scn):
    ref = synth_scenario_blocks(scn, 5, 1, noise_std=0.0)
    dev = DeviceScenarioSynth(scn, noise_std=0.0)
    got = np.asarray(dev.chunk(5, 1))
    assert np.abs(got - ref).mean() < 2e-3


def test_oscillator_model_matches_oracle():
    """+-2 ppm TCXO model (common Doppler + code-clock skew): the device
    linearized synth must track the warped-time numpy oracle."""
    scn = make_scenario(CFG, n_sats=2, duration_sec=12.0, seed=4,
                        osc_ppm=2.0, osc_ppm_rate=1.65e-3)
    ref = synth_scenario_blocks(scn, 3, 2, noise_std=0.0)
    dev = DeviceScenarioSynth(scn, noise_std=0.0)
    got = np.asarray(dev.chunk(3, 2))
    err = np.abs(got - ref)
    assert np.quantile(err, 0.999) < 2e-2
    assert err.mean() < 2e-3


def test_oscillator_offsets_measured_doppler():
    """A +2 ppm oscillator must shift every satellite's observed carrier
    by ~ -2e-6 * L1 (~ -3151 Hz) relative to the unimpaired scenario."""
    from gps_sdr.config import L1_FREQ

    base = make_scenario(CFG, n_sats=1, duration_sec=8.0, seed=7)
    imp = make_scenario(CFG, n_sats=1, duration_sec=8.0, seed=7,
                        osc_ppm=2.0)
    b0 = synth_scenario_blocks(base, 0, 1, noise_std=0.0)[0]
    b1 = synth_scenario_blocks(imp, 0, 1, noise_std=0.0)[0]
    # dominant tone of the conjugate product = frequency difference
    prod = b1 * np.conj(b0)
    spec = np.abs(np.fft.fft(prod))
    df_bins = np.fft.fftfreq(len(prod), 1.0 / CFG.sample_rate)
    df = df_bins[int(np.argmax(spec))]
    assert abs(df - (-2e-6 * L1_FREQ)) < 40.0     # within ~1 FFT bin


def test_chunk_continuity(scn):
    dev = DeviceScenarioSynth(scn, noise_std=0.0)
    whole = np.asarray(dev.chunk(0, 2))
    parts = np.concatenate([np.asarray(dev.chunk(0, 1)),
                            np.asarray(dev.chunk(1, 1))])
    np.testing.assert_allclose(parts, whole, atol=1e-5)


def test_knot_interp_params_match_exact():
    """The long-horizon fast path (knot_interp_step: Catmull-Rom over
    0.1 s nodes) must reproduce the exact per-interval linearization to
    f32 rounding — interpolation error of the light-time solution is
    ~3e-15 s at this step, far below the f32 quantization the params
    already carry."""
    import numpy as np

    from gps_sdr.config import ReceiverConfig
    from gps_sdr.models.scenario import make_scenario
    from gps_sdr.models.scenario_jax import DeviceScenarioSynth

    cfg = ReceiverConfig()
    scn = make_scenario(cfg, n_sats=6, seed=7, duration_sec=8.0)
    a = DeviceScenarioSynth(scn, noise_std=0.5)
    b = DeviceScenarioSynth(scn, noise_std=0.5, knot_interp_step=0.1)
    for first in (0, 32, 96):
        pa = np.stack(a._params(first, 32))
        pb = np.stack(b._params(first, 32))
        # (phase0, phase_rate, c0, crate, bit_a, bit_b, bit_x)
        tol = [2e-5, 1e-8, 2e-4, 1e-7, 0, 0, 5e-4]
        for i, t in enumerate(tol):
            assert np.abs(pa[i] - pb[i]).max() <= t, (i, float(
                np.abs(pa[i] - pb[i]).max()))
