"""ops/dft at the code lengths the receiver uses: 2048 (2.048 MS/s)
up to 16384 (the 16 MS/s front end, BASELINE.md), against numpy's
float64 FFT."""

import numpy as np
import jax.numpy as jnp
import pytest

from gps_sdr.ops import dft as dftmod


@pytest.mark.parametrize("n", [2048, 4096, 16384])
@pytest.mark.parametrize("batch", [(), (3,)])
def test_dft_matches_fft(n, batch):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(batch + (n,))
         + 1j * rng.standard_normal(batch + (n,))).astype(np.complex64)
    got = np.asarray(dftmod.dft(jnp.asarray(x)))
    assert got.dtype == np.complex64
    ref = np.fft.fft(x.astype(np.complex128), axis=-1)
    scale = np.abs(ref).max()
    # float32 butterflies: error grows ~log2(n) * 6e-8 relative
    assert np.abs(got - ref).max() / scale < 2e-5


@pytest.mark.parametrize("n", [2048, 16384])
def test_idft_roundtrip(n):
    rng = np.random.default_rng(n + 1)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    y = dftmod.idft(dftmod.dft(jnp.asarray(x)))
    np.testing.assert_allclose(np.asarray(y), x, atol=5e-3)


def test_acquisition_at_16msps():
    """Cold-start acquisition on a 16.384 MS/s front end
    (code_samples=16384)."""
    from gps_sdr.config import ReceiverConfig
    from gps_sdr.models.simulator import SatSignal, synth_stream
    from gps_sdr.ops import cacode
    from gps_sdr.ops.acquisition import acquire_all

    cfg = ReceiverConfig(code_samples=16384, n_cyc=8, corr_avg=4,
                         sweep_corr_avg=2)
    assert cfg.sample_rate == 16_384_000.0
    sats = [SatSignal(prn=4, doppler=2100.0, code_delay=5000.0),
            SatSignal(prn=27, doppler=-3300.0, code_delay=12000.5)]
    block = synth_stream(cfg, sats, 1, noise_std=0.3, seed=5)[0]
    found = acquire_all(cfg, block, cacode.ca_fft_table(cfg),
                        prns=[4, 9, 27])
    by_prn = {f[1]: f for f in found}
    assert set(by_prn) == {4, 27}
    assert abs(by_prn[4][3] - 5000) <= 1
    assert abs(by_prn[27][3] - 12000) <= 1
    assert abs(by_prn[4][2] - 2100.0) < cfg.step_freq


@pytest.mark.parametrize("n", [1024, 2048])
def test_idft_matches_numpy(n):
    """idft against numpy's float64 inverse FFT, including the 1/n
    normalization the correlator's peak heights depend on."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((4, n))
         + 1j * rng.standard_normal((4, n))).astype(np.complex64)
    got = np.asarray(dftmod.idft(jnp.asarray(x)))
    assert got.dtype == np.complex64
    ref = np.fft.ifft(x.astype(np.complex128), axis=-1)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() / scale < 2e-5
