"""Digital front end: FIR decimation + digital
downconversion (DDC).

The reference is hardwired to one front end — an RTL-SDR delivering
complex baseband at exactly 2.048 MS/s (gpsrecv.py:41-43,
gpsglob.py:119-125).  This module lets captures from better hardware
feed the same 2.048 MS/s processing chain:

  * integer-factor decimation of higher-rate complex IQ
    (Airspy/HackRF/SDRplay-class captures at M x 2.048 MS/s), and
  * digital downconversion of REAL-sampled IF captures (mix to
    baseband, then decimate) — the common output of non-quadrature
    front ends.

Device mapping: the anti-alias FIR is applied as ONE strided
convolution (`lax.conv_general_dilated` with window stride = the
decimation factor) at HIGHEST precision — a float32 convolution may
otherwise run in TF32 (~3 decimal digits) on a GPU; the NCO mix is the same
factorized oscillator the tracking wipeoff uses (ops/dsp.doppler_mix).
Chunk streaming is stateful: the `Frontend` wrapper carries the
(taps-1)-sample seam and the NCO phase across chunks so arbitrarily
long captures decimate with zero boundary artifacts.

Filter design is plain windowed-sinc (Hamming) — host numpy, computed
once.

Also here: narrowband-interference excision (`excise_cw`).  A CW tone
at J/S above ~+15 dB captures every channel's PLL (measured: all
tracked carriers dragged by a common several-hundred-Hz offset, decode
destroyed) — the dominant real-world RFI mode the reference has no
answer to.  A tone is a handful of bins in a 32 ms block spectrum, so
the fix is frequency-domain excision: one DFT per block, null bins
whose magnitude exceeds a multiple of
the block's mean |X|, inverse DFT.  The C/A signal spreads over
+-1 MHz, so losing tens of bins costs < 0.1 dB of SNR while removing
the tone entirely.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array


def design_lowpass(num_taps: int, cutoff: float) -> np.ndarray:
    """Hamming-windowed-sinc lowpass; `cutoff` is the -6 dB edge as a
    fraction of the INPUT Nyquist (0 < cutoff < 1).  Odd-length,
    unit-DC-gain, linear phase."""
    if num_taps % 2 == 0:
        num_taps += 1
    n = np.arange(num_taps) - (num_taps - 1) / 2
    h = np.sinc(cutoff * n) * np.hamming(num_taps)
    return (h / h.sum()).astype(np.float32)


def decimation_taps(factor: int, taps_per_phase: int = 16) -> np.ndarray:
    """Anti-alias filter for an integer decimation: passband covers the
    C/A main lobe (+-1.024 MHz of the 2.048 MS/s output), stopband at
    the output Nyquist."""
    return design_lowpass(factor * taps_per_phase, 1.0 / factor)


def _fir_decimate(x_planar: Array, taps: Array, factor: int) -> Array:
    """Strided 'valid' convolution: x_planar f32[2, n] (re/im rows),
    taps f32[t] -> f32[2, (n - t)//factor + 1]."""
    lhs = x_planar[:, None, :]                      # [batch=2, chan=1, n]
    rhs = taps[None, None, ::-1]                    # [out=1, in=1, t]
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(factor,), padding="VALID",
        precision=jax.lax.Precision.HIGHEST)
    return out[:, 0, :]


@jax.jit
def _mix_real_to_baseband(x: Array, f_ratio: Array,
                          phase0: Array) -> Array:
    """Real IF samples f32[n] * exp(-j 2 pi (phase0 + f_ratio * k)) ->
    planar f32[2, n]; f_ratio = f_if / fs_in (cycles per sample)."""
    n = x.shape[0]
    ang = 2.0 * jnp.pi * (phase0 + f_ratio
                          * jnp.arange(n, dtype=jnp.float32))
    return jnp.stack([x * jnp.cos(ang), -x * jnp.sin(ang)])


class Frontend:
    """Stateful chunked decimator / DDC.

    feed(samples) -> complex64 output samples at fs_in / factor.
    `samples` is complex IQ (factor-rate capture) or real IF samples
    (when f_if is given).  The seam starts zero-filled, so every chunk
    is processed uniformly and output sample k carries the filtered
    signal at input time k*factor - (taps-1)/2: a pure group delay of
    (taps-1)/2 input samples (the first (taps-1)//factor outputs are
    the startup transient) — common to every satellite, absorbed by
    the receiver's clock unknown like any front-end filter's latency.
    """

    def __init__(self, factor: int, f_if: float = 0.0,
                 fs_in: float = 0.0, taps: np.ndarray | None = None):
        self.factor = int(factor)
        self.taps = jnp.asarray(taps if taps is not None
                                else decimation_taps(self.factor))
        self.n_taps = int(self.taps.shape[0])
        self.f_if = float(f_if)
        self.fs_in = float(fs_in)
        if self.f_if and not self.fs_in:
            raise ValueError("fs_in required with f_if")
        self._tail = np.zeros((2, self.n_taps - 1), np.float32)
        self._phase = 0.0            # NCO phase [cycles]
        self._dec = jax.jit(_fir_decimate, static_argnums=(2,))

    def feed(self, samples: np.ndarray) -> np.ndarray:
        """Consume input samples, return decimated complex64 (possibly
        empty while the seam fills)."""
        if self.f_if:
            x = jnp.asarray(np.asarray(samples, np.float32))
            planar = np.asarray(_mix_real_to_baseband(
                x, jnp.float32(self.f_if / self.fs_in),
                jnp.float32(self._phase)))
            self._phase = float(
                (self._phase + self.f_if / self.fs_in * x.shape[0])
                % 1.0)
        else:
            c = np.asarray(samples)
            planar = np.stack([c.real.astype(np.float32),
                               c.imag.astype(np.float32)])
        buf = np.concatenate([self._tail, planar], axis=1)
        n_out = (buf.shape[1] - self.n_taps) // self.factor + 1
        if n_out <= 0:
            self._tail = buf
            return np.zeros(0, np.complex64)
        used = (n_out - 1) * self.factor + self.n_taps
        out = np.asarray(self._dec(jnp.asarray(buf[:, :used]),
                                   self.taps, self.factor))
        # seam: keep everything the NEXT output sample's window needs
        self._tail = buf[:, n_out * self.factor:]
        return (out[0] + 1j * out[1]).astype(np.complex64)


def frontend_blocks(sample_iter, cfg, factor: int, f_if: float = 0.0,
                    fs_in: float = 0.0):
    """Adapt a raw high-rate sample stream into standard ngps-sample
    complex64 blocks (the shape every Receiver source yields)."""
    fe = Frontend(factor, f_if=f_if, fs_in=fs_in)
    pend = np.zeros(0, np.complex64)
    for chunk in sample_iter:
        pend = np.concatenate([pend, fe.feed(chunk)])
        while pend.shape[0] >= cfg.ngps:
            yield pend[:cfg.ngps]
            pend = pend[cfg.ngps:]


# -- narrowband (CW) interference excision ---------------------------------

def excise_cw_block(block, threshold: float):
    """Null spectral bins above threshold*mean|X| in one IQ block.

    block: complex64[n] (or anything as_complex_input accepts).
    Returns complex64[n].  A CW interferer concentrates its power in a
    few of the n bins; GPS signal + noise spread evenly, so the block's
    mean magnitude is a robust floor estimate (one hot bin in tens of
    thousands barely moves the mean) and bins above `threshold` times
    it are interference by construction.  Zeroing them removes the
    tone's mainlobe; the C/A correlation loses only the excised
    fraction of its bandwidth.
    """
    from gps_sdr.ops.dft import dft, idft
    from gps_sdr.ops.dsp import as_complex_input

    x = as_complex_input(block)
    spec = dft(x)
    mag = jnp.abs(spec)
    keep = mag <= jnp.float32(threshold) * jnp.mean(mag)
    return idft(spec * keep)


def excise_cw_chunk(cfg, stacked):
    """vmap excise_cw_block over a [T, ...] tracking chunk, preserving
    the input layout (complex [T, n], planar f32 [T, 2, n], or grouped
    planar f32 [T, 2, n_cyc, cs])."""
    from gps_sdr.ops.dsp import is_grouped_iq

    planar = (not jnp.issubdtype(stacked.dtype, jnp.complexfloating))
    grouped = is_grouped_iq(cfg, stacked)
    out = jax.vmap(
        lambda b: excise_cw_block(b, cfg.cw_excision))(stacked)
    if planar:
        out = jnp.stack([jnp.real(out), jnp.imag(out)], axis=1)
        if grouped:
            out = out.reshape(stacked.shape)
    return out
