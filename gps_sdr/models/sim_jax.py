"""Device-side (JAX) parametric IQ synthesis.

The numpy simulator (models/simulator.py) is exact but host-bound; for
benchmark-scale streams (minutes-hours of 2.048 MS/s IQ) generation must
run on the accelerator.  This module produces the same signal model with
f32-safe per-block arithmetic: the host carries exact float64 origins
(code position, carrier phase, bit index) per satellite per block, and
the jitted kernel only ever sees block-relative values, which fit f32
comfortably (65536 samples * max rates << f32 mantissa).

Matches models/simulator.py to within f32 rounding; verified by test.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from gps_sdr.config import BIT_MS, ReceiverConfig
from gps_sdr.models.simulator import SatSignal
from gps_sdr.ops.cacode import ca_table

MAX_BITS = 2048     # nav bit window uploaded per satellite


@jax.jit
def _to_complex(planar):
    """Grouped planar [T, 2, n_cyc, cs] -> complex64 [T, ngps]."""
    c = jax.lax.complex(planar[..., 0, :, :], planar[..., 1, :, :])
    return c.reshape(c.shape[:-2] + (-1,))


@functools.partial(jax.jit, static_argnums=(0,))
def _synth_block(cfg: ReceiverConfig, codes, nav_bits, amp, pos0, pos_rate,
                 phase0, phase_rate, bit_base, noise_std, seed):
    """One block for all satellites.

    codes:      f32[S, code_samples]
    nav_bits:   i8[S, MAX_BITS] window of nav bits
    pos0:       f32[S] code position at sample 0, in [0, code_samples)
    pos_rate:   f32[S] code position change per sample (~1)
    phase0:     f32[S] carrier phase at sample 0, in [0, 2*pi)
    phase_rate: f32[S] carrier phase change per sample
    bit_base:   i32[S] code-period index at pos0's period, relative to the
                first bit in nav_bits window times BIT_MS

    Gather-free: the naive formulation gathers code[i0 % cs] at every
    one of the 65,536 samples.  Because the code position advances by pr ~= 1 sample/sample,
    i0(k) = k + d(k) where the drift d(k) = floor(p0 + (pr-1)k) is
    piecewise constant with AT MOST ONE integer step per block
    (|pr-1| * ngps < 0.25).  So code lookup becomes two dynamic slices
    of a tiled code table (one per drift level) + an elementwise select,
    and the nav-bit lookup becomes the same trick on a per-period bit
    vector.  Also keeps full f32 precision: drift stays < 2049 while
    the naive pos = p0 + pr*k loses sub-sample resolution at k ~ 2^16.
    """
    cs = cfg.code_samples
    n = cfg.ngps
    n_rep = n // cs + 3
    k = jnp.arange(n, dtype=jnp.float32)

    def one_sat(code, bits, a, p0, pr, ph0, phr, bb):
        drift = p0 + (pr - 1.0) * k             # i0(k) = k + floor(drift)
        d = jnp.floor(drift)
        frac = drift - d                        # sub-sample code phase
        d0 = d[0].astype(jnp.int32)
        step = (d[-1] - d[0]).astype(jnp.int32)  # -1, 0, or +1
        on_d0 = (d == d[0])

        tiled = jnp.tile(code, n_rep)           # [n + 3cs]
        base = d0 % cs + cs                     # keep slice starts >= 0

        def at(j):                              # code[(k + d0 + j) % cs]
            return jax.lax.dynamic_slice(tiled, (base + j,), (n,))

        c0 = jnp.where(on_d0, at(0), at(step))
        c1 = jnp.where(on_d0, at(1), at(1 + step))
        cv = c0 * (1.0 - frac) + c1 * frac

        # nav bit per code period, then the same slice-select expansion
        pp = jnp.arange(n_rep + 1, dtype=jnp.int32) - 1
        bpp = bits[jnp.clip((bb.astype(jnp.int32) + pp) // BIT_MS,
                            0, bits.shape[0] - 1)]  # tiny gather
        brep = jnp.repeat(bpp, cs)              # [(n_rep+1) * cs]

        def bat(j):                             # bit of period(k) at drift j
            return jax.lax.dynamic_slice(brep, (base + j,), (n,))

        bv = jnp.where(on_d0, bat(0), bat(step))

        ang = ph0 + phr * k
        env = a * bv * cv
        # planar re/im in real arithmetic
        return jnp.stack([env * jnp.cos(ang), env * jnp.sin(ang)])

    sig = jax.vmap(one_sat)(codes, nav_bits, amp, pos0, pos_rate, phase0,
                            phase_rate, bit_base)
    out = jnp.sum(sig, axis=0)                           # [2, n]
    key = jax.random.PRNGKey(0)
    key = jax.random.fold_in(key, seed.astype(jnp.int32))
    noise = jnp.stack([
        jax.random.normal(key, (n,), jnp.float32),
        jax.random.normal(jax.random.fold_in(key, 1), (n,), jnp.float32)])
    # grouped planar [2, n_cyc, cs] (the reshape fuses into this jit's
    # output write)
    return (out + noise_std * noise).astype(jnp.float32).reshape(
        2, cfg.n_cyc, cs)


@functools.partial(jax.jit, static_argnums=(0,))
def _synth_chunk(cfg: ReceiverConfig, codes, nav_bits, amp, origins,
                 noise_std, seeds):
    """T blocks in one call; origins f32[5, T, S] stacked (pos0,
    pos_rate, phase0, phase_rate, bit_base) — one array, one upload."""
    pos0, pos_rate, phase0, phase_rate, bit_base = origins

    def one(x):
        p0, pr, ph0, phr, bb, seed = x
        return _synth_block(cfg, codes, nav_bits, amp, p0, pr, ph0, phr,
                            bb, noise_std, seed)

    # lax.map (not vmap): keeps the per-satellite [S, ngps] intermediate
    # to one block at a time, so arbitrarily long chunks fit in HBM
    return jax.lax.map(one, (pos0, pos_rate, phase0, phase_rate,
                             bit_base, seeds))


@dataclass
class JaxSynth:
    """Streaming device-side generator for a fixed satellite set."""

    cfg: ReceiverConfig
    sats: list            # [SatSignal]
    noise_std: float = 0.7
    seed: int = 0

    def __post_init__(self):
        cfg = self.cfg
        table = ca_table(cfg)
        self._codes = jnp.asarray(
            np.stack([table[s.prn] for s in self.sats]))
        # nav bits uploaded as f32 (the transfer boundary's dtype); the
        # window grows with the longest provided stream so hours-long
        # runs never clamp into constant bits
        n_bits = max(MAX_BITS, max(len(s.nav_bits) for s in self.sats))
        bits = np.zeros((len(self.sats), n_bits), np.float32)
        for i, s in enumerate(self.sats):
            m = min(len(s.nav_bits), n_bits)
            bits[i, :m] = s.nav_bits[:m]
            bits[i, m:] = s.nav_bits[-1] if m else 1
        self._bits = jnp.asarray(bits)
        self._amp = jnp.asarray([s.amplitude for s in self.sats],
                                jnp.float32)

    def _origins(self, blocks: np.ndarray):
        """Exact per-block f64 origins for each satellite (host side)."""
        cfg = self.cfg
        fs = cfg.sample_rate
        n0 = blocks[:, None] * cfg.ngps                      # [T, 1]
        rate = np.array([1.0 - s.delay_rate(cfg) / fs
                         for s in self.sats])                # [S]
        drate = np.array([s.delay_rate(cfg) for s in self.sats])
        delay0 = np.array([s.code_delay for s in self.sats])
        dop = np.array([s.doppler for s in self.sats])
        cph = np.array([s.carrier_phase for s in self.sats])
        boff = np.array([s.bit_offset_ms for s in self.sats])
        p_abs = n0 - (delay0 + drate * n0 / fs)              # [T, S]
        period0 = np.floor(p_abs / cfg.code_samples)
        pos0 = p_abs - period0 * cfg.code_samples
        ph = np.mod(2.0 * np.pi * dop * n0 / fs + cph, 2.0 * np.pi)
        ph_rate = np.broadcast_to(2.0 * np.pi * dop / fs, pos0.shape)
        pos_rate = np.broadcast_to(rate, pos0.shape)
        bit_base = period0 + boff
        return (pos0.astype(np.float32), pos_rate.astype(np.float32),
                ph.astype(np.float32), ph_rate.astype(np.float32),
                bit_base.astype(np.float32))

    def chunk_planar(self, first_block: int, n_blocks: int) -> jax.Array:
        """Generate blocks [first_block, first_block + n_blocks) in ONE
        device call; GROUPED planar f32[n_blocks, 2, n_cyc, cs] re/im —
        the on-device chunk layout.  One call per chunk: every call
        pays a fixed dispatch cost."""
        idx = np.arange(first_block, first_block + n_blocks)
        origins = np.stack(self._origins(idx))
        seeds = ((self.seed * 9973 + idx) % 8_388_608).astype(np.float32)
        return _synth_chunk(
            self.cfg, self._codes, self._bits, self._amp,
            jnp.asarray(origins), jnp.float32(self.noise_std),
            jnp.asarray(seeds))

    def chunk(self, first_block: int, n_blocks: int) -> jax.Array:
        """Like chunk_planar but complex64[n_blocks, ngps]."""
        return _to_complex(self.chunk_planar(first_block, n_blocks))

    def block(self, b: int) -> jax.Array:
        """Generate one block (convenience; prefer chunk())."""
        return self.chunk(b, 1)[0]

    def blocks(self, first: int, count: int):
        for b in range(first, first + count):
            yield self.block(b)
