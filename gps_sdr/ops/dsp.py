"""Core DSP primitives for acquisition and tracking.

Pure jittable/vmappable functions in complex64/float32 (the reference's
deliberate DSP dtype policy, src/gpsglob.py:127-131).  These replace the
reference's scipy.fft hot loops (src/gpslib.py:1315-1346,
src/gpsrecv.py:232-274) with batched XLA programs.

Conventions match the reference exactly:
  * Doppler wipeoff multiplies by exp(-j(phase + 2*pi*f*t)) with
    t = (1..N)/fs (one-based sample times! gpsrecv.py:32, gpslib.py:1053).
  * Circular correlation is |ifft(fft(data_seg_mean) * conj(fft(code)))|;
    a peak at index DS means the code starts DS samples into the data
    (gpslib.py:1308-1327).
  * A peak is accepted if (max - mean)/std > corr_min (gpslib.py:1293).
  * Sub-sample code phase is the mean of a triangle fit and a parabola
    fit around the peak (gpslib.py:1268-1290).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gps_sdr.ops.dft import dft, idft

Array = jax.Array


def as_complex_input(x: Array) -> Array:
    """Accept complex64[...], f32[..., 2] re/im pairs (the host<->device
    boundary carries f32 only), f32[..., 2, N] planar re/im, or grouped
    planar f32[..., 2, n_cyc, cs] (the device synthesizers' layout)."""
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        return x
    if x.shape[-1] == 2:
        return jax.lax.complex(x[..., 0], x[..., 1])
    if x.ndim >= 2 and x.shape[-2] == 2:
        return jax.lax.complex(x[..., 0, :], x[..., 1, :])
    if x.ndim >= 3 and x.shape[-3] == 2:
        # grouped planar f32[..., 2, n_cyc, cs]: merge the period axes
        c = jax.lax.complex(x[..., 0, :, :], x[..., 1, :, :])
        return c.reshape(c.shape[:-2] + (-1,))
    raise ValueError(f"not an IQ layout: {x.dtype}{x.shape}")


def is_grouped_iq(cfg, x: Array) -> bool:
    """True for the grouped planar f32[..., 2, n_cyc, cs] IQ layout.

    The device synthesizers emit this layout.  The shape test is exact
    against the config, so a flat [T=2, 2, ngps] chunk can never be
    mistaken for grouped (ngps = n_cyc*cs > cs always).
    """
    return (not jnp.issubdtype(x.dtype, jnp.complexfloating)
            and x.ndim >= 3
            and x.shape[-3:] == (2, cfg.n_cyc, cfg.code_samples))


def doppler_mix(data: Array, freq: Array, phase: Array,
                sample_rate: float) -> tuple[Array, Array]:
    """Wipe off Doppler: data * exp(-j(phase + 2*pi*f*t)), t=(1..N)/fs.

    Returns the mixed block and the carrier phase advanced to the end of
    the block, wrapped to [0, 2*pi) (reference demodDoppler,
    src/gpslib.py:1343-1346).

    The oscillator is factorized: with ang = phase + s*(1..N) and
    N = Q*R, exp(-i*ang) = exp(-i*phase) * exp(-i*s*R)^q * exp(-i*s*r)
    computed as an outer product of a Q-point and an R-point table —
    ~N/Q transcendental evaluations instead of N (the sin/cos of the
    naive form dominates the mixing cost; the angles of both
    tables are evaluated directly, so there is no recurrence drift).
    """
    n = data.shape[-1]
    s = jnp.float32(2.0 * jnp.pi) * jnp.float32(freq) \
        / jnp.float32(sample_rate)
    new_phase = jnp.remainder(jnp.float32(phase) + s * n,
                              jnp.float32(2.0 * jnp.pi))
    r_len = 2048 if n % 2048 == 0 else n
    q_len = n // r_len
    # r-table covers ang(phase + s*(1..R)); q-table adds s*R*q
    ang_r = jnp.float32(phase) + s * jnp.arange(1, r_len + 1,
                                                dtype=jnp.float32)
    ang_q = jnp.remainder(s * r_len, jnp.float32(2.0 * jnp.pi)) \
        * jnp.arange(q_len, dtype=jnp.float32)
    osc_r = jax.lax.complex(jnp.cos(ang_r), -jnp.sin(ang_r))
    osc_q = jax.lax.complex(jnp.cos(ang_q), -jnp.sin(ang_q))
    osc = (osc_q[:, None] * osc_r[None, :]).reshape(n)
    return data * osc, new_phase


def segment_fft_mean(data: Array, code_samples: int, first_seg: int,
                     n_avg: int) -> Array:
    """Mean of the FFTs of `n_avg` code-length segments of `data`.

    Segments are taken starting at segment index `first_seg` (static), so
    tracking can correlate against the center of the block
    (gpslib.py:1315-1323: p = (n_cyc - corr_avg)//2).
    """
    segs = data[first_seg * code_samples:(first_seg + n_avg) * code_samples]
    segs = segs.reshape(n_avg, code_samples)
    # DFT is linear: mean of the segment DFTs == DFT of the mean
    # segment — one transform instead of n_avg (the reference averages
    # in the frequency domain, gpslib.py:1315-1323; identical result)
    return dft(jnp.mean(segs, axis=0))


def circ_correlate(fft_data: Array, code_fft: Array) -> Array:
    """|idft(fft_data * conj(code_fft))| — circular correlation magnitude.

    DFTs via ops/dft.py."""
    return jnp.abs(idft(fft_data * jnp.conjugate(code_fft)))


def fit_peak(corr: Array, mx: Array) -> Array:
    """Sub-sample peak location: mean of triangle and parabola fits.

    Mirrors fitCodePhase (src/gpslib.py:1268-1290); neighbours wrap
    circularly.  Returns a float32 code phase in [-0.5, len(corr)-0.5).
    """
    n = corr.shape[-1]
    cm = corr[(mx - 1) % n]
    cp = corr[(mx + 1) % n]
    c0 = corr[mx]
    tri = jnp.where(cm > cp,
                    0.5 * (cp - cm) / (c0 - cp),
                    0.5 * (cp - cm) / (c0 - cm))
    par = 0.5 * (cp - cm) / (2.0 * c0 - cp - cm)
    return mx.astype(jnp.float32) + 0.5 * (tri + par)


def peak_metrics(corr: Array, corr_min: float) -> tuple[Array, Array, Array]:
    """(delay, code_phase, norm_max) from a correlation curve.

    delay = argmax if the normalized peak exceeds corr_min else -1;
    code_phase is the sub-sample fit (or -1.0).  Mirrors findCodePhase
    (src/gpslib.py:1293-1304).
    """
    mean = jnp.mean(corr)
    std = jnp.std(corr)
    mx = jnp.argmax(corr)
    norm_max = (corr[mx] - mean) / std
    found = norm_max > corr_min
    delay = jnp.where(found, mx.astype(jnp.int32), jnp.int32(-1))
    code_phase = jnp.where(found, fit_peak(corr, mx), jnp.float32(-1.0))
    return delay, code_phase, norm_max


def roll_code(code: Array, delay: Array) -> Array:
    """Circularly roll a code right by `delay` samples (dynamic).

    Equivalent to np.roll(code, +delay); used for code wipeoff
    (gpslib.py:1400: np.roll(CACODE_REP, delay) == tile(roll(code, delay))).
    """
    n = code.shape[-1]
    idx = (jnp.arange(n) - delay) % n
    return code[idx]


def roll_code_fft(code_fft: Array, delay: Array) -> Array:
    """np.roll(code, +delay) computed from the code's DFT.

    rolled = Re(idft(code_fft * exp(-2*pi*i*f*delay/n))) — a phase-ramp
    multiply plus one inverse DFT, in place of roll_code's dynamic
    gather (a vmapped gather over [channels, 2048]).  Roundtrip error
    ~1e-5 relative — far below the noise floor of any correlation or
    decode use.
    """
    n = code_fft.shape[-1]
    # exact modular phase: (f*delay) mod n keeps the f32 angle < 2*pi
    m = (jnp.arange(n, dtype=jnp.int32) * delay.astype(jnp.int32)) % n
    ang = jnp.float32(2.0 * jnp.pi / n) * m.astype(jnp.float32)
    ramp = jax.lax.complex(jnp.cos(ang), -jnp.sin(ang))
    return jnp.real(idft(code_fft * ramp))
