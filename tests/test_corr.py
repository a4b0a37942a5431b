"""Tracking correlator (dsp.circ_correlate + dsp.peak_metrics) against a
numpy float64 oracle: circular correlation magnitude, normalized peak
height, integer delay and the sub-sample peak fit."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from chip_smoke import peak_oracle
from gps_sdr.ops import dsp


def _mk(n=256, k=3, c=2, seed=0, peaky=True):
    rng = np.random.default_rng(seed)
    code = np.sign(rng.standard_normal((c, n))).astype(np.float32)
    code_fft = np.fft.fft(code, axis=-1).astype(np.complex64)
    x = (rng.standard_normal((k, c, n)) * 0.3).astype(np.float32)
    xi = (rng.standard_normal((k, c, n)) * 0.3).astype(np.float32)
    if peaky:
        # embed a rolled code so there is a real correlation peak
        for ki in range(k):
            for ci in range(c):
                sh = (17 * ki + 41 * ci) % n
                x[ki, ci] += np.roll(code[ci], sh)
    return x + 1j * xi, code_fft


def _device(x, code_fft, corr_min):
    """The device chain on [k, c, n] segments: DFT of the data, then
    circ_correlate + peak_metrics per (k, c) row."""
    spec = jnp.fft.fft(jnp.asarray(x.astype(np.complex64)), axis=-1)
    corr = dsp.circ_correlate(spec, jnp.asarray(code_fft)[None])
    got = jax.vmap(jax.vmap(lambda cr: dsp.peak_metrics(cr, corr_min)))(corr)
    return corr, [np.asarray(g) for g in got]


def _oracle(x, code_fft, corr_min):
    spec = np.fft.fft(x.astype(np.complex128), axis=-1)
    corr = np.abs(np.fft.ifft(spec * np.conj(
        code_fft.astype(np.complex128))[None], axis=-1))
    flat = corr.reshape(-1, corr.shape[-1])
    d, p, nm = peak_oracle(flat, corr_min)
    shape = corr.shape[:-1]
    return corr, d.reshape(shape), p.reshape(shape), nm.reshape(shape)


@pytest.mark.parametrize("peaky", [True, False])
def test_detects_peaks_and_rejects_noise(peaky):
    x, code_fft = _mk(peaky=peaky)
    _, (d, p, nm) = _device(x, code_fft, 6.0)
    _, d0, p0, n0 = _oracle(x, code_fft, 6.0)
    np.testing.assert_array_equal(d, d0)
    np.testing.assert_allclose(nm, n0, rtol=1e-4)
    np.testing.assert_allclose(p, p0, atol=1e-3)
    if peaky:
        assert (d >= 0).all()
    else:
        assert (d == -1).all()     # pure noise: below the 6-sigma gate


def test_matches_original_dsp_chain():
    """Correlation magnitudes and peak metrics against float64 numpy;
    float32 rounding bounds the magnitude error to ~1e-5 relative."""
    x, code_fft = _mk(n=512, k=2, c=3, seed=7)
    corr, (d, p, nm) = _device(x, code_fft, 6.0)
    c0, d0, p0, n0 = _oracle(x, code_fft, 6.0)
    assert np.abs(np.asarray(corr) - c0).max() / c0.max() < 1e-5
    np.testing.assert_array_equal(d, d0)
    np.testing.assert_allclose(p, p0, atol=1e-3)
    np.testing.assert_allclose(nm, n0, rtol=1e-4)


def test_peak_on_every_lag_alignment():
    """The argmax and sub-sample fit must hit the exact lag for every
    circular shift m."""
    n = 64
    rng = np.random.default_rng(3)
    code = np.sign(rng.standard_normal(n)).astype(np.float32)
    code_fft = np.fft.fft(code).astype(np.complex64)[None]
    lags = np.arange(n)
    x = np.stack([np.roll(code, m) for m in lags])[:, None, :] + 0j
    _, (d, p, _) = _device(x, code_fft, 3.0)
    _, d0, p0, _ = _oracle(x, code_fft, 3.0)
    np.testing.assert_array_equal(d[:, 0], lags)
    np.testing.assert_array_equal(d0[:, 0], lags)
    np.testing.assert_allclose(p[:, 0], lags, atol=1e-2)
