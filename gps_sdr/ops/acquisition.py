"""Batched cold-start / re-acquisition over the PRN x Doppler grid.

Replacement for the reference's incremental sweep
(sweepAllSats, src/gpsrecv.py:241-274, throttled to 10 Doppler steps per
32 ms block so a full +-5 kHz scan took ~5 blocks on CPU; and the
per-channel sweepFrequency, src/gpslib.py:1362-1380, throttled to 40
steps/block).  Here the *entire* grid — every Doppler bin x every PRN x
all 2048 code phases — is evaluated on one block in a single jitted
program: mix the block with all Doppler bins at once, FFT-average
`sweep_corr_avg` code periods per bin, broadcast against all code FFTs,
IFFT, and reduce.

Deviation from the reference (documented): the reference records the
*first* Doppler bin (scanning upward) whose peak exceeds the threshold;
this kernel records the *best* bin, which is strictly more accurate and
is only possible because the whole grid fits in one shot.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from gps_sdr.config import ReceiverConfig
from gps_sdr.ops import dsp

Array = jax.Array


class AcqResult(NamedTuple):
    """Per-PRN acquisition result (row index = position in `prns` input).

    All leaves are f32 (the host<->device boundary carries f32 only):
    `found` is 0.0/1.0 and `delay` is an integer-valued float."""

    found: Array      # f32[P]; 1.0 if peak above threshold
    freq: Array       # f32[P]; best Doppler bin
    delay: Array      # f32[P]; integer code phase of the peak (-1 if none)
    norm_max: Array   # f32[P]; peak height in sigmas at the best bin
    code_phase: Array  # f32[P]; sub-sample peak fit


def acquire_impl(cfg: ReceiverConfig, block: Array, dopplers: Array,
                 code_ffts: Array) -> AcqResult:
    """Full-grid acquisition on one block.

    block:     complex64[>= acq_noncoherent * sweep_corr_avg *
               code_samples]
    dopplers:  float32[D] Doppler bins to test
    code_ffts: complex64[P, code_samples] FFTs of candidate PRN codes

    Cost (defaults): D=51 bins x (4 FFT-2048) + D x P=31 IFFT-2048 —
    one shot instead of the reference's ~5-block staged scan.

    cfg.acq_noncoherent = K > 1 averages the correlation MAGNITUDE over
    K consecutive sweep windows (K * sweep_corr_avg * 1 ms of signal;
    K <= 8 fits inside one 32 ms block), buying ~1.5 dB of acquisition
    sensitivity per doubling without the bit-transition / Doppler-bin
    coherence limits a longer coherent average would hit.  The
    reference always detects on a single 4 ms window and is blind below
    its 8-sigma floor.  Code-phase drift across the K windows is
    <= 0.2 samples per 4 ms at the search-band edge — negligible
    smearing at K <= 8.
    """
    cs = cfg.code_samples
    k = max(1, int(cfg.acq_noncoherent))
    n = cfg.sweep_corr_avg * cs
    block = dsp.as_complex_input(block)
    code_ffts = dsp.as_complex_input(code_ffts)
    data = block[:k * n].reshape(k, n)
    def per_doppler(freq):
        # each window mixes from phase 0 — the windows are combined
        # noncoherently (magnitudes), so inter-window carrier phase is
        # irrelevant; the k=1 path is bit-identical to the original
        # single-window program
        def per_win(d):
            mixed, _ = dsp.doppler_mix(d, freq, jnp.float32(0.0),
                                       cfg.sample_rate)
            return dsp.segment_fft_mean(mixed, cs, 0, cfg.sweep_corr_avg)
        return jax.vmap(per_win)(data)                      # [k, cs]

    fft_means = jax.vmap(per_doppler)(
        dopplers.astype(jnp.float32))                       # [D, k, cs]

    # corr[D, P, cs]: noncoherent mean of |corr| over the k windows,
    # then per-(D,P) normalized peak metrics
    corr = jnp.mean(jnp.abs(dsp.idft(
        fft_means[:, :, None, :]
        * jnp.conjugate(code_ffts)[None, None, :, :])), axis=1)
    mean = jnp.mean(corr, axis=-1)
    std = jnp.std(corr, axis=-1)
    peak = jnp.max(corr, axis=-1)
    mx = jnp.argmax(corr, axis=-1)
    norm = (peak - mean) / std                                  # [D, P]

    best_d = jnp.argmax(norm, axis=0)                           # [P]
    p_idx = jnp.arange(code_ffts.shape[0])
    best_norm = norm[best_d, p_idx]
    best_mx = mx[best_d, p_idx]
    best_corr = corr[best_d, p_idx, :]                          # [P, cs]
    code_phase = jax.vmap(dsp.fit_peak)(best_corr, best_mx)

    found = best_norm > cfg.corr_min
    return AcqResult(
        found=found.astype(jnp.float32),
        freq=dopplers.astype(jnp.float32)[best_d],
        delay=jnp.where(found, best_mx.astype(jnp.float32),
                        jnp.float32(-1)),
        norm_max=best_norm,
        code_phase=jnp.where(found, code_phase, -1.0),
    )


acquire = functools.partial(jax.jit, static_argnums=(0,))(acquire_impl)


def acquire_all(cfg: ReceiverConfig, block: np.ndarray,
                code_fft_table: np.ndarray,
                prns=None, dopplers=None
                ) -> list[tuple[float, int, float, int]]:
    """Host convenience: acquire `prns` (default: the full search list) on
    one block and return found satellites sorted by correlation strength,
    as (norm_max, prn, freq, delay) tuples — the shape the reference's
    channel-selection policy consumes (gpsrecv.py:274, 423-440).
    `dopplers` overrides the config's search bins (almanac warm start).
    """
    from gps_sdr.ops.tracking import to_f32_pairs

    prns = list(cfg.prns if prns is None else prns)
    if dopplers is None:
        dopplers = cfg.doppler_bins
    if isinstance(block, np.ndarray) and block.dtype != np.float32:
        block = to_f32_pairs(block)
    block = jnp.asarray(block)
    if cfg.cw_excision > 0:
        # null narrowband interference before the grid search (same
        # front-end defense the tracking chunk applies; frontend.py)
        from gps_sdr.ops.frontend import excise_cw_block
        block = jax.jit(excise_cw_block, static_argnums=1)(
            block, cfg.cw_excision)
    res = acquire(cfg, jnp.asarray(block),
                  jnp.asarray(dopplers, dtype=np.float32),
                  jnp.asarray(to_f32_pairs(code_fft_table[np.asarray(prns)])))
    found = np.asarray(res.found) > 0.5
    norm = np.asarray(res.norm_max)
    freq = np.asarray(res.freq)
    delay = np.rint(np.asarray(res.delay)).astype(np.int32)
    out = [(float(norm[i]), prns[i], float(freq[i]), int(delay[i]))
           for i in range(len(prns)) if found[i]]
    return sorted(out, reverse=True)
