"""Synthetic GPS L1 C/A IQ generation — the framework's test oracle.

The reference has no signal simulator; its only end-to-end check is a
recorded capture (README.md:177-185).  This module generates IQ streams
with exactly known ground truth so acquisition, tracking, bit decode and
positioning can be verified in closed loop (SURVEY.md section 4/7).

Two modes:
  * Parametric (`SatSignal` + `synth_stream`): per-satellite Doppler,
    code delay, drift and nav-bit sequence are given directly.  Used for
    DSP-layer tests.
  * Physical (`models/scenario.py`): receiver position + ephemerides ->
    geometric delays and subframe streams; used for the full
    acquisition->fix closed loop.

Signal model (matches the receiver's front-end conventions,
src/gpsrecv.py:168-172 normalization and src/gpslib.py sampling):
  sample n at t = n/fs:
    s(t) = sum_s A_s * D_s(t) * C_s((n - d_s(t)) mod code_samples)
               * exp(j(2*pi*f_s*t + phi_s))  + AWGN
  where d_s(t) = d0_s + ddot_s*t is the code delay in samples (code
  Doppler: ddot ~= -doppler/L1 * fs, i.e. <= 6.5 samples/s at 5 kHz,
  matching the reference's maxSlope 6.55e-3 samples/ms,
  src/gpslib.py:812), C_s is the 2048-sample resampled code and D_s the
  +-1 nav bit active during the code period.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from gps_sdr.config import BIT_MS, L1_FREQ, ReceiverConfig
from gps_sdr.ops.cacode import ca_table


@dataclass
class SatSignal:
    """Parametric ground truth for one simulated satellite."""

    prn: int
    doppler: float                 # Hz, carrier Doppler
    code_delay: float = 0.0        # samples, delay at t=0 (0..code_samples)
    amplitude: float = 1.0
    carrier_phase: float = 0.0     # rad
    nav_bits: np.ndarray = field(
        default_factory=lambda: np.ones(1, dtype=np.int8))
    bit_offset_ms: int = 0         # ms already elapsed of nav_bits[0] at the
                                   # code period containing sample 0
    code_doppler: float | None = None  # samples/s; None -> -doppler/L1*fs

    def delay_rate(self, cfg: ReceiverConfig) -> float:
        if self.code_doppler is not None:
            return self.code_doppler
        return -self.doppler / L1_FREQ * cfg.sample_rate


def synth_stream(cfg: ReceiverConfig, sats: list[SatSignal], n_blocks: int,
                 noise_std: float = 0.0, seed: int = 0,
                 dtype=np.complex64) -> np.ndarray:
    """Generate `n_blocks` blocks of parametric IQ; returns [n_blocks, ngps]."""
    return synth_stream_chunk(cfg, sats, 0, n_blocks, noise_std, seed, dtype)


def synth_stream_chunk(cfg: ReceiverConfig, sats: list[SatSignal],
                       first_block: int, n_blocks: int,
                       noise_std: float = 0.0, seed: int = 0,
                       dtype=np.complex64) -> np.ndarray:
    """Generate blocks [first_block, first_block+n_blocks) of the same
    stream `synth_stream` would produce — chunkwise generation with a
    consistent absolute time origin, so hours-long streams never
    materialize in memory."""
    fs = cfg.sample_rate
    cs = cfg.code_samples
    n = n_blocks * cfg.ngps
    sample0 = first_block * cfg.ngps
    t = (sample0 + np.arange(n, dtype=np.float64)) / fs
    table = ca_table(cfg)

    out = np.zeros(n, dtype=np.complex128)
    for s in sats:
        code = table[s.prn].astype(np.float64)
        d = s.code_delay + s.delay_rate(cfg) * t
        pos = (sample0 + np.arange(n, dtype=np.float64)) - d
        # fractional-delay code value via circular linear interpolation —
        # truncating to integer sample positions would quantize the code
        # delay into a 1-sample staircase and break sub-sample tests
        xpos = np.mod(pos, cs)
        i0 = np.floor(xpos).astype(np.int64)
        frac = xpos - i0
        code_val = code[i0] * (1.0 - frac) + code[(i0 + 1) % cs] * frac
        period = np.floor(pos / cs).astype(np.int64)  # code period index
        bit_idx = (period + s.bit_offset_ms) // BIT_MS
        bits = s.nav_bits[np.clip(bit_idx, 0, len(s.nav_bits) - 1)]
        # cos/sin instead of np.exp(1j*x): numpy's complex exp is ~100x
        # slower than separate real trig on some hosts
        ang = 2 * np.pi * s.doppler * t + s.carrier_phase
        carrier = np.cos(ang) + 1j * np.sin(ang)
        out += s.amplitude * bits * code_val * carrier

    if noise_std > 0:
        # per-block noise streams keyed by absolute block index so any
        # chunking of the same stream yields identical samples
        out = out.reshape(n_blocks, cfg.ngps)
        for b in range(n_blocks):
            rng = np.random.default_rng((seed, first_block + b))
            out[b] += noise_std * (rng.standard_normal(cfg.ngps)
                                   + 1j * rng.standard_normal(cfg.ngps))
        out = out.reshape(-1)
    return out.astype(dtype).reshape(n_blocks, cfg.ngps)


def random_bits(n: int, seed: int = 1) -> np.ndarray:
    """Random +-1 nav bit sequence."""
    rng = np.random.default_rng(seed)
    return (2 * rng.integers(0, 2, size=n) - 1).astype(np.int8)
