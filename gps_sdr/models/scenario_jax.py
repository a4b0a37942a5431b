"""Device-side synthesis of physical scenarios.

The numpy oracle (models/scenario.py) evaluates the full light-time /
Sagnac / SV-clock model per sample in float64 — exact, but minutes of
host time for tens of seconds of IQ.  Here the host evaluates the model
only at 1 ms knots (the same knots the oracle interpolates from) and
linearizes each knot interval into f32-safe per-interval parameters:

    carrier:  phase0 (mod 2*pi) + rate * k          [rad, rad/sample]
    code:     chip position c0 (mod 1023) + crate*k [chips/sample]
    nav bit:  value before/after the (at most one) 20 ms bit boundary
              crossing the interval, and its sample position

The device kernel then expands the per-sample waveform.  Within one
interval the exact model deviates from the linearization by < 1e-17 s
of tau (range acceleration over 1 ms) — orders of magnitude below the
f32 rounding already accepted — so device output matches the oracle to
f32 interpolation error (tested).

This keeps the full closed loop (orbits -> IQ -> receiver -> fix) on
the device in plain XLA (the chip lookup is a gather; cf. sim_jax's
gather-free parametric synthesizer).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from gps_sdr.config import CA_CHIPS, L1_FREQ, ReceiverConfig
from gps_sdr.ops.cacode import ca_chips

BIT_SEC = 0.020


@jax.jit
def _to_complex(planar):
    """Grouped planar [T, 2, n_cyc, cs] -> complex64 [T, ngps]."""
    c = jax.lax.complex(planar[..., 0, :, :], planar[..., 1, :, :])
    return c.reshape(c.shape[:-2] + (-1,))


@functools.partial(jax.jit, static_argnums=(0,))
def _synth_chunk_dev(cfg: ReceiverConfig, chips, params, amp, noise_std,
                     seeds):
    """IQ for B blocks from per-interval linearized parameters.

    chips: f32[S, 1023]; params f32[7, B, n_cyc, S] stacked
    (phase0, phase_rate, c0, crate, bit_a, bit_b, bit_x) — ONE array,
    one upload; amp f32[S]; returns grouped planar f32[B, 2, n_cyc, cs].
    """
    (phase0, phase_rate, c0, crate, bit_a, bit_b, bit_x) = params
    cs = cfg.code_samples
    k = jnp.arange(cs, dtype=jnp.float32)

    def one_interval(ph0, phr, cc0, ccr, ba, bb, bx, a, chip_tab):
        # [S] params -> [S, cs] contributions, summed over sats;
        # planar re/im in real arithmetic
        ang = ph0[:, None] + phr[:, None] * k[None, :]
        cpos = cc0[:, None] + ccr[:, None] * k[None, :]
        idx = jnp.floor(cpos).astype(jnp.int32) % CA_CHIPS
        cv = jnp.take_along_axis(chip_tab, idx, axis=1)
        bit = jnp.where(k[None, :] < bx[:, None], ba[:, None],
                        bb[:, None])
        env = a[:, None] * bit * cv
        return (jnp.sum(env * jnp.cos(ang), axis=0),
                jnp.sum(env * jnp.sin(ang), axis=0))

    b, n_cyc, s = phase0.shape
    flat = lambda x: x.reshape(b * n_cyc, s)
    seg_re, seg_im = jax.vmap(one_interval,
                              in_axes=(0, 0, 0, 0, 0, 0, 0, None, None))(
        flat(phase0), flat(phase_rate), flat(c0), flat(crate),
        flat(bit_a), flat(bit_b), flat(bit_x), amp, chips)
    # grouped planar [b, 2, n_cyc, cs]: the on-device chunk layout
    out = jnp.stack([seg_re.reshape(b, n_cyc, cs),
                     seg_im.reshape(b, n_cyc, cs)], axis=1)

    # noise keyed per ABSOLUTE block (seeds[b] = f(seed, first+b)), so
    # the stream is invariant to how callers chunk their requests —
    # chunk_planar(0, w*t) == w calls of t blocks (the fused-window
    # dispatch fetches whole windows; host scenario.py keys the same
    # way, rng((seed, first_block + b)))
    keys = jax.vmap(lambda s: jax.random.fold_in(
        jax.random.PRNGKey(0), s.astype(jnp.int32)))(seeds)
    noise = jax.vmap(lambda kk: jnp.stack(
        [jax.random.normal(kk, (n_cyc, cs), jnp.float32),
         jax.random.normal(jax.random.fold_in(kk, 1), (n_cyc, cs),
                           jnp.float32)]))(keys)
    return (out + noise_std * noise).astype(jnp.float32)


@dataclass
class DeviceScenarioSynth:
    """Chunkwise device synthesis of a models/scenario.py Scenario.

    knot_interp_step (seconds, 0 = off) enables the long-horizon fast
    path: (tau, tau_sv) are evaluated exactly only at absolute-time
    nodes t_rx0 + m*h and Catmull-Rom-interpolated to the 1 ms knots.
    The light-time solution's third derivative is ~3e-12 s/s^3, so at
    h=0.1 s the interpolation error is ~3e-15 s — five orders below
    the f32 rounding the linearization already accepts — while cutting
    the per-chunk host orbit work ~100x (long soak runs were
    bottlenecked on _params).  Nodes are keyed by absolute
    index, so chunking stays phase-continuous by construction."""

    scn: object
    noise_std: float = 0.5
    seed: int = 1
    knot_interp_step: float = 0.0

    def __post_init__(self):
        self._node_cache: dict = {}     # prn -> {m: (tau, tau_sv)}
        self._tau_ref: dict = {}        # prn -> tau at t_rx0 (constant)
        # expand satellites into rays: direct path + optional specular
        # multipath (SatScenario.multipath), plus CW interference tones
        # (Scenario.cw_tones) which need no kernel support — a tone is
        # just a ray with an all-ones chip table and zero chip rate
        rays = []           # (sat | None, delta_s, rel_amp, rel_phase)
        chip_rows = []
        amps = []
        from gps_sdr.config import CA_CHIP_RATE
        for s in self.scn.sats:
            rays.append((s, 0.0, 1.0, 0.0))
            chip_rows.append(ca_chips(s.prn))
            amps.append(s.amplitude)
            if s.multipath is not None:
                d_chips, rel_amp, rel_phase = s.multipath
                rays.append((s, d_chips / CA_CHIP_RATE, rel_amp,
                             rel_phase))
                chip_rows.append(ca_chips(s.prn))
                amps.append(s.amplitude * rel_amp)
        for f_hz, amp, ph0 in getattr(self.scn, "cw_tones", ()):
            rays.append((None, f_hz, 1.0, ph0))
            chip_rows.append(np.ones(CA_CHIPS))
            amps.append(amp)
        self._rays = rays
        self._chips = jnp.asarray(
            np.stack(chip_rows).astype(np.float32))
        self._amp = jnp.asarray(amps, jnp.float32)

    def _params(self, first_block: int, n_blocks: int):
        """Host: exact f64 knots -> f32 per-interval linearization."""
        scn, cfg = self.scn, self.scn.cfg
        fs, cs, n_cyc = cfg.sample_rate, cfg.code_samples, cfg.n_cyc
        n_iv = n_blocks * n_cyc
        sample0 = first_block * cfg.ngps
        # receiver-oscillator warp (Scenario.clock_err): knot times lag
        # the nominal sample grid, and the LO term below adds the
        # common carrier offset — mirrors the numpy oracle exactly
        dt_nom = (sample0 + np.arange(n_iv + 1) * cs) / fs
        ce_k = scn.clock_err(dt_nom)
        knots = scn.t_rx0 + dt_nom - ce_k
        shape = (n_blocks, n_cyc, len(self._rays))
        ph0 = np.empty(shape, np.float32)
        phr = np.empty(shape, np.float32)
        c0 = np.empty(shape, np.float32)
        cr = np.empty(shape, np.float32)
        ba = np.empty(shape, np.float32)
        bb = np.empty(shape, np.float32)
        bx = np.empty(shape, np.float32)
        states_cache: dict = {}
        for si, (sat, delta, _rel_amp, rel_phase) in enumerate(self._rays):
            if sat is None:
                # CW tone: delta carries freq_hz, rel_phase is phase0;
                # baseband phase 2*pi*(f*dt_nom - L1*clock_err) + ph0
                cyc = delta * dt_nom - L1_FREQ * ce_k
                p0 = 2.0 * np.pi * np.mod(cyc[:-1], 1.0) + rel_phase
                pr = 2.0 * np.pi * (np.diff(cyc) / cs)
                ph0[:, :, si] = p0.astype(np.float32).reshape(n_blocks,
                                                              n_cyc)
                phr[:, :, si] = pr.astype(np.float32).reshape(n_blocks,
                                                              n_cyc)
                c0[:, :, si] = 0.0
                cr[:, :, si] = 0.0
                ba[:, :, si] = 1.0
                bb[:, :, si] = 1.0
                bx[:, :, si] = cs + 1.0
                continue
            if sat.prn not in states_cache:
                if self.knot_interp_step > 0:
                    taus = self._sat_tau_interp(knots, sat)
                else:
                    taus = scn.sat_states(knots, sat)
                ref = self._tau_ref.get(sat.prn)
                if ref is None:       # constant — one exact solve ever
                    ref = float(scn.sat_states(
                        np.array([scn.t_rx0]), sat)[0][0])
                    self._tau_ref[sat.prn] = ref
                states_cache[sat.prn] = (taus, ref)
            (tau_k0, tau_sv_k0), tau_ref = states_cache[sat.prn]
            # a multipath ray is the same signal delta seconds farther:
            # chips/bits older by delta, carrier picking up the
            # physical -2*pi*L1*delta plus the configured rel_phase
            tau_k = tau_k0 + delta
            tau_sv_k = tau_sv_k0 - delta
            # carrier: -2*pi*L1*(tau - tau_ref + clock_err), continuous
            cyc = L1_FREQ * (tau_k - tau_ref + ce_k)
            p0 = (-2.0 * np.pi) * np.mod(cyc[:-1], 1.0) + rel_phase
            pr = (-2.0 * np.pi) * (np.diff(cyc) / cs)
            # code: chips = tau_sv * 1023000 (mod 1023)
            chip_pos = tau_sv_k * (CA_CHIPS * 1000.0)
            cc0 = np.mod(chip_pos[:-1], CA_CHIPS)
            ccr = np.diff(chip_pos) / cs
            # nav bit: at most one 20 ms boundary per 1 ms interval
            bidx0 = np.floor(tau_sv_k[:-1] / BIT_SEC).astype(np.int64)
            bidx1 = np.floor(tau_sv_k[1:] / BIT_SEC).astype(np.int64)
            stream = sat.nav_stream

            def bit_of(idx):
                return stream[np.clip(idx - sat.bit0, 0,
                                      len(stream) - 1)]

            a_ = bit_of(bidx0).astype(np.float32)
            b_ = bit_of(bidx1).astype(np.float32)
            # crossing sample: tau_sv hits (bidx0+1)*BIT_SEC
            dtau = tau_sv_k[1:] - tau_sv_k[:-1]
            x_ = ((bidx0 + 1) * BIT_SEC - tau_sv_k[:-1]) \
                / np.maximum(dtau, 1e-12) * cs
            x_ = np.where(bidx1 > bidx0, x_, cs + 1.0)
            ph0[:, :, si] = p0.astype(np.float32).reshape(n_blocks, n_cyc)
            phr[:, :, si] = pr.reshape(n_blocks, n_cyc)
            c0[:, :, si] = cc0.reshape(n_blocks, n_cyc)
            cr[:, :, si] = ccr.reshape(n_blocks, n_cyc)
            ba[:, :, si] = a_.reshape(n_blocks, n_cyc)
            bb[:, :, si] = b_.reshape(n_blocks, n_cyc)
            bx[:, :, si] = x_.astype(np.float32).reshape(n_blocks, n_cyc)
        return ph0, phr, c0, cr, ba, bb, bx

    def _sat_tau_interp(self, knots: np.ndarray, sat):
        """(tau, tau_sv) at `knots` by Catmull-Rom over the absolute
        node grid t_rx0 + m*h (nodes computed exactly once, cached)."""
        scn = self.scn
        h = self.knot_interp_step
        m0 = int(np.floor((knots[0] - scn.t_rx0) / h)) - 1
        m1 = int(np.ceil((knots[-1] - scn.t_rx0) / h)) + 2
        cache = self._node_cache.setdefault(sat.prn, {})
        missing = [m for m in range(m0, m1 + 1) if m not in cache]
        if missing:
            ts = scn.t_rx0 + np.asarray(missing, np.float64) * h
            tau_m, tsv_m = scn.sat_states(ts, sat)
            for m, a, b in zip(missing, tau_m, tsv_m):
                cache[m] = (float(a), float(b))
            # chunks advance monotonically: nodes far below this
            # window are never read again — evict so an hours-scale
            # soak doesn't grow the cache without bound
            stale = [m for m in cache if m < m0 - 4]
            for m in stale:
                del cache[m]
        ms = range(m0, m1 + 1)
        tau_n = np.array([cache[m][0] for m in ms], np.float64)
        tsv_n = np.array([cache[m][1] for m in ms], np.float64)
        x = (knots - scn.t_rx0) / h - m0
        i = np.clip(np.floor(x).astype(np.int64), 1, len(tau_n) - 3)
        u = x - i

        def cr(p):
            p0, p1, p2, p3 = p[i - 1], p[i], p[i + 1], p[i + 2]
            return p1 + 0.5 * u * (
                p2 - p0 + u * (2 * p0 - 5 * p1 + 4 * p2 - p3
                               + u * (3 * (p1 - p2) + p3 - p0)))

        return cr(tau_n), cr(tsv_n)

    def chunk_planar(self, first_block: int, n_blocks: int) -> jax.Array:
        """Grouped planar f32[n_blocks, 2, n_cyc, cs] re/im on device
        (the on-device chunk layout)."""
        p = np.stack(self._params(first_block, n_blocks))
        seeds = ((self.seed * 7919
                  + np.arange(first_block, first_block + n_blocks))
                 % 8_388_608).astype(np.float32)
        return _synth_chunk_dev(
            self.scn.cfg, self._chips, jnp.asarray(p),
            self._amp, jnp.float32(self.noise_std), jnp.asarray(seeds))

    def chunk(self, first_block: int, n_blocks: int) -> jax.Array:
        """complex64[n_blocks, ngps] on device."""
        return _to_complex(self.chunk_planar(first_block, n_blocks))
