"""DSP primitive tests: Doppler wipeoff, correlation, sub-sample peak fit."""

import jax.numpy as jnp
import numpy as np

from gps_sdr.config import DEFAULT as CFG
from gps_sdr.ops import cacode, dsp


def test_doppler_mix_removes_tone():
    fs = CFG.sample_rate
    n = 4096
    t = np.arange(1, n + 1) / fs
    f0, ph0 = 1234.0, 0.7
    tone = np.exp(1j * (ph0 + 2 * np.pi * f0 * t)).astype(np.complex64)
    mixed, new_phase = dsp.doppler_mix(jnp.asarray(tone), f0, ph0, fs)
    mixed = np.asarray(mixed)
    np.testing.assert_allclose(mixed.real, 1.0, atol=1e-3)
    np.testing.assert_allclose(mixed.imag, 0.0, atol=1e-3)
    expect = (ph0 + 2 * np.pi * f0 * t[-1]) % (2 * np.pi)
    assert abs(float(new_phase) - expect) % (2 * np.pi) < 1e-2


def test_phase_continuity_across_blocks():
    """Mixing two consecutive blocks with carried phase equals mixing the
    concatenated stream (the reference's continuous-phase property)."""
    fs = CFG.sample_rate
    f0 = 2500.0
    n = 2048
    t = np.arange(1, 2 * n + 1) / fs
    sig = np.exp(1j * 2 * np.pi * 777.0 * t).astype(np.complex64)
    whole, _ = dsp.doppler_mix(jnp.asarray(sig), f0, 0.0, fs)
    b1, p1 = dsp.doppler_mix(jnp.asarray(sig[:n]), f0, 0.0, fs)
    b2, _ = dsp.doppler_mix(jnp.asarray(sig[n:]), f0, p1, fs)
    np.testing.assert_allclose(np.asarray(whole)[n:], np.asarray(b2),
                               atol=5e-3)


def test_correlation_finds_shift():
    code = cacode.ca_table(CFG)[11]
    for shift in (0, 1, 513, 2047):
        data = np.tile(np.roll(code, shift), CFG.corr_avg).astype(np.complex64)
        fft_mean = dsp.segment_fft_mean(jnp.asarray(data), CFG.code_samples,
                                        0, CFG.corr_avg)
        corr = dsp.circ_correlate(fft_mean,
                                  jnp.asarray(cacode.ca_fft_table(CFG)[11]))
        delay, code_phase, norm_max = dsp.peak_metrics(corr, CFG.corr_min)
        assert int(delay) == shift
        assert float(norm_max) > 20
        assert abs(float(code_phase) - shift) < 0.5


def test_fit_peak_subsample():
    """A fractional-sample shift is recovered to < 0.1 samples."""
    code = cacode.ca_table(CFG)[23].astype(np.float64)
    frac_shift = 700.3
    # fractional roll via Fourier shift theorem
    n = len(code)
    k = np.fft.fftfreq(n) * n
    shifted = np.fft.ifft(np.fft.fft(code)
                          * np.exp(-2j * np.pi * k * frac_shift / n))
    data = np.tile(shifted, CFG.corr_avg).astype(np.complex64)
    fft_mean = dsp.segment_fft_mean(jnp.asarray(data), CFG.code_samples,
                                    0, CFG.corr_avg)
    corr = dsp.circ_correlate(fft_mean,
                              jnp.asarray(cacode.ca_fft_table(CFG)[23]))
    _, code_phase, _ = dsp.peak_metrics(corr, CFG.corr_min)
    assert abs(float(code_phase) - frac_shift) < 0.1


def test_roll_code_matches_numpy():
    code = cacode.ca_table(CFG)[3]
    for d in (0, 5, 2047):
        np.testing.assert_array_equal(
            np.asarray(dsp.roll_code(jnp.asarray(code), d)),
            np.roll(code, d))
