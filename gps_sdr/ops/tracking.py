"""Scan-based per-channel code/carrier tracking.

Redesign of the reference's per-satellite worker processes:
`class SatStream` (src/gpslib.py:1044-1634) ran one mutable state machine
per OS process, fed 32 ms blocks over multiprocessing queues
(src/gpsrecv.py:300-417).  Here every `self.X` becomes a field of the
`ChannelState` pytree, channels are a vmapped batch axis, and blocks are
consumed by `lax.scan` — one jitted program tracks all channels for a
whole ~1 s chunk without touching the host.

Semantics preserved per block (reference SatStream.process,
gpslib.py:1141-1210):
  1. stream-skip detection -> erase demod carry state (gpslib.py:1143-46)
  2. Doppler wipeoff with continuous carrier phase (gpslib.py:1178)
  3. FFT circular correlation of `corr_avg` center code periods ->
     integer delay + sub-sample code phase (gpslib.py:1179, 1315-1327)
  4. correlation-quality history ring (CORRLST, gpslib.py:1331-1339)
  5. code wipeoff + per-ms coherent integration with block-boundary
     carryover (decodeData, gpslib.py:1394-1446); the variable-length
     PREV_SAMPLES tail becomes a (sum, count) scalar carry
  6. bit-edge event detection with 3-sigma amplitude gate -> fixed-size
     event slots (gpslib.py:1421-1434)
  7. phase-locked loop: arctan(Q/I), pi-step unwrap, drift feed-forward
     from a ring of recent df values, 20 Hz/s slew limit
     (phaseLockedLoop, gpslib.py:1215-1262)

Sweep (re-acquisition) is *not* a device-side branch: under vmap both
sides of a cond execute for every lane, so the reference's per-channel
incremental sweep (gpslib.py:1362-1380) would multiply the hot-path cost
for all channels.  Instead the step emits a `sweep_request` flag and the
host services it between chunks with one batched full-grid acquisition
(ops/acquisition.py) — same trigger (60 s correlation quality < -0.9,
gpslib.py:1134-1138), strictly faster re-acquisition.

Bit/subframe assembly stays on the host (models/navmsg.py): edges arrive
at <= 50 events/s/channel, far below device bandwidth concerns.
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


class ChannelState(NamedTuple):
    """Per-channel tracking state; every field mirrors a SatStream member."""

    prn: Array            # i32; 0 = slot empty
    active: Array         # bool
    freq: Array           # f32, Doppler estimate (SatStream.FREQ)
    phase: Array          # f32, carrier phase accumulator (SatStream.PHASE)
    delay: Array          # i32, integer code phase (SatStream.DELAY)
    locked: Array         # bool (SatStream.PHASE_LOCKED)
    ms_time: Array        # i32, ms since lock (SatStream.MS_TIME)
    std_dev: Array        # f32 (SatStream.STD_DEV; edge gate uses prev block)
    prev_stream: Array    # i32 (SatStream.PREV_STREAM_NO)
    prev_signal: Array    # f32 (SatStream.PREV_SIGNAL)
    sign0: Array          # i8; EDGES[0]: sign of first mean after lock
    prev_sign: Array      # i8; sign after the last accepted edge
    carry_sum: Array      # c64; sum of the partial tail segment
    carry_cnt: Array      # i32; samples in the tail (= len(PREV_SAMPLES))
    df_buf: Array         # f32[no_sec]; ring of recent df (SatStream.DF)
    df_cnt: Array         # i32
    df_idx: Array         # i32; next write slot
    corr_buf: Array       # i8[corr_hist_len] (SatStream.CORRLST)
    corr_cnt: Array       # i32
    corr_idx: Array       # i32


class ChannelOut(NamedTuple):
    """Per-block outputs (host consumes one stacked chunk per second)."""

    code_phase: Array     # f32; sub-sample code phase, -1 if no peak
    delay: Array          # i32
    norm_max: Array       # f32; normalized correlation peak height
    amplitude: Array      # f32
    corr_q: Array         # f32; 60 s correlation quality
    corr_l: Array         # f32; 1 s correlation quality
    freq: Array           # f32
    locked: Array         # bool
    erased: Array         # bool; stream skip wiped edge/bit continuity
    sweep_request: Array  # bool; host should re-acquire this channel
    sign0: Array          # i8; current first-sign state (for host EDGES[0])
    edge_ms: Array        # i32[n_cyc+1]; ms_time of edge events
    edge_local: Array     # i32[n_cyc+1]; sample offset of event segment
                          #   start, relative to this block's first sample
    edge_valid: Array     # bool[n_cyc+1]


as_complex = dsp.as_complex_input


def to_f32_pairs(x) -> "np.ndarray":
    """Host-side complex -> f32[..., 2] for upload."""
    x = np.asarray(x)
    return np.stack([x.real.astype(np.float32),
                     x.imag.astype(np.float32)], axis=-1)


def to_grouped_planar(cfg, x) -> "np.ndarray":
    """Host-side complex chunk [T, ngps] -> grouped planar
    f32[T, 2, n_cyc, cs], the on-device chunk layout the device
    synthesizers and replay uploads share."""
    x = np.asarray(x)
    t = x.shape[0]
    out = np.empty((t, 2, cfg.n_cyc, cfg.code_samples), np.float32)
    flat = out.reshape(t, 2, cfg.ngps)
    flat[:, 0] = x.real
    flat[:, 1] = x.imag
    return out


@functools.partial(jax.jit, static_argnums=(0, 1))
def init_channel_states(cfg: ReceiverConfig, n_channels: int) -> ChannelState:
    # jitted so the buffers are CREATED on device (no host constants
    # cross the f32-only transfer boundary).
    # NOTE: every field gets its own buffer — the state pytree is donated
    # to jitted updates, and aliased leaves would be double-donated
    c = n_channels

    def z32():
        return jnp.zeros((c,), jnp.int32)

    def zf():
        return jnp.zeros((c,), jnp.float32)

    return ChannelState(
        prn=z32(), active=jnp.zeros((c,), bool), freq=zf(), phase=zf(),
        delay=z32(), locked=jnp.zeros((c,), bool), ms_time=z32(),
        std_dev=jnp.full((c,), 0.005, jnp.float32), prev_stream=z32(),
        prev_signal=zf(), sign0=jnp.zeros((c,), jnp.int8),
        prev_sign=jnp.zeros((c,), jnp.int8),
        carry_sum=jnp.zeros((c,), jnp.complex64), carry_cnt=z32(),
        df_buf=jnp.zeros((c, cfg.no_sec), jnp.float32),
        df_cnt=jnp.ones((c,), jnp.int32), df_idx=jnp.ones((c,), jnp.int32),
        corr_buf=jnp.zeros((c, cfg.corr_hist_len), jnp.int8),
        corr_cnt=jnp.ones((c,), jnp.int32),
        corr_idx=jnp.ones((c,), jnp.int32),
    )


@functools.partial(jax.jit, static_argnums=(0,), donate_argnums=(1,))
def _reset_slot(cfg: ReceiverConfig, state: ChannelState, slot_f, prn_f,
                freq_f, delay_f, active_f) -> ChannelState:
    """All-scalar-f32 slot reset (f32-only transfer boundary)."""
    slot = slot_f.astype(jnp.int32)
    one = init_channel_states(cfg, 1)
    new = one._replace(
        prn=prn_f.astype(jnp.int32)[None],
        active=(active_f > 0)[None],
        freq=freq_f[None],
        delay=delay_f.astype(jnp.int32)[None],
        prev_stream=jax.lax.dynamic_slice(state.prev_stream, (slot,), (1,)),
    )
    return jax.tree.map(
        lambda s, n: jax.lax.dynamic_update_index_in_dim(s, n[0], slot, 0),
        state, new)


def reset_channel(state: ChannelState, slot: int, prn: int, freq: float,
                  delay: int, cfg: ReceiverConfig,
                  active: bool = True) -> ChannelState:
    """Host-side (re)initialization of one channel slot.

    Equivalent to constructing a fresh SatStream (gpslib.py:1050-1091) or
    to setPhaseUnlocked + frequency update after a sweep
    (gpslib.py:1102-1120).
    """
    return _reset_slot(cfg, state, jnp.float32(slot), jnp.float32(prn),
                       jnp.float32(freq), jnp.float32(delay),
                       jnp.float32(1.0 if active else 0.0))


# ---------------------------------------------------------------------------


def _segment_sums_rolled(mixed: Array, rolled: Array, delay: Array,
                         cfg: ReceiverConfig):
    """Head sum + per-segment sums for boundaries delay + k*cs, given
    the already-rolled code.

    Gather-free: segment k spans the tail of code-period row k plus the
    head of row k+1, so two masked row reductions give every boundary
    sum (no dynamic slicing — under vmap a dynamic_slice lowers to a
    full-width gather).
    """
    cs, n_cyc = cfg.code_samples, cfg.n_cyc
    rows = (mixed.reshape(n_cyc, cs)
            * jnp.broadcast_to(rolled, (n_cyc, cs)))
    in_head = (jnp.arange(cs) < delay).astype(jnp.float32)[None, :]
    lo = jnp.sum(rows * in_head, axis=1)          # cols <  delay
    hi = jnp.sum(rows, axis=1) - lo               # cols >= delay
    head = lo[0]
    seg_sums = hi + jnp.concatenate([lo[1:], jnp.zeros((1,), lo.dtype)])
    return head, seg_sums


def _segment_sums(mixed: Array, code_fft: Array, delay: Array,
                  cfg: ReceiverConfig):
    """_segment_sums_rolled with the roll computed from the code's DFT
    (FFT-domain phase ramp — the gather roll was the hottest op of the
    whole tracking scan, see dsp.roll_code_fft)."""
    rolled = dsp.roll_code_fft(code_fft, delay)
    return _segment_sums_rolled(mixed, rolled, delay, cfg)


def _decode_means(mixed: Array, code_fft: Array, delay: Array,
                  carry_sum: Array, carry_cnt: Array, cfg: ReceiverConfig):
    """Code wipeoff + per-ms coherent means with scalar tail carry.

    Replaces decodeData's variable-length PREV_SAMPLES concatenation
    (gpslib.py:1394-1446): segment boundaries sit at delay + k*2048, the
    leading partial segment is completed from (carry_sum, carry_cnt), and
    the trailing partial segment becomes the next carry.  Emits a fixed
    n_cyc+1 slot layout: slot 0 = carry-completed mean (may be invalid),
    slots 1..n_cyc = full segments (last one invalid unless delay == 0).
    """
    head, seg_sums = _segment_sums(mixed, code_fft, delay, cfg)
    return _means_from_sums(head, seg_sums, delay, carry_sum, carry_cnt,
                            cfg)


def _means_from_sums(head: Array, seg_sums: Array, delay: Array,
                     carry_sum: Array, carry_cnt: Array,
                     cfg: ReceiverConfig):
    """Assemble the fixed n_cyc+1 means layout from (head, seg_sums) —
    the cheap, carry-dependent tail of _decode_means (separated so the
    expensive sums can be batched over blocks while the carry chains
    through a scalar scan, channel_step_k)."""
    cs, n_cyc = cfg.code_samples, cfg.n_cyc
    cnt0 = carry_cnt + delay
    mean0 = (carry_sum + head) / jnp.maximum(cnt0, 1).astype(jnp.float32)
    v0 = cnt0 > 0
    k_full = n_cyc - (delay > 0).astype(jnp.int32)   # complete segments

    means = jnp.concatenate([mean0[None], seg_sums / jnp.float32(cs)])
    starts = jnp.concatenate([
        (-carry_cnt)[None],
        delay + cs * jnp.arange(n_cyc, dtype=jnp.int32),
    ]).astype(jnp.int32)
    valid = jnp.concatenate([
        v0[None], jnp.arange(n_cyc, dtype=jnp.int32) < k_full])

    new_carry_sum = jnp.where(delay > 0, seg_sums[n_cyc - 1],
                              jnp.complex64(0))
    new_carry_cnt = jnp.where(delay > 0, cs - delay, 0).astype(jnp.int32)

    # Compact so valid means are contiguous and time-ordered.
    means = jnp.where(v0, means, jnp.roll(means, -1))
    starts = jnp.where(v0, starts, jnp.roll(starts, -1))
    n_valid = k_full + v0.astype(jnp.int32)
    mask = jnp.arange(n_cyc + 1) < n_valid
    return means, starts, mask, n_valid, new_carry_sum, new_carry_cnt


def _edge_scan_seq(means: Array, starts: Array, mask: Array, locked: Array,
                   min_edge_amp: Array, sign0, prev_sign, prev_signal,
                   ms_time):
    """Reference sequential form of the edge detector (a 33-step scalar
    lax.scan); kept as the equivalence oracle for _edge_scan below."""
    def body(carry, x):
        s0, psign, psig, mst = carry
        m, start, valid = x
        do = valid & locked
        re = m.real
        msign = jnp.where(re >= 0, 1, -1).astype(jnp.int8)
        first = s0 == 0
        is_edge = ((~first) & (msign != psign)
                   & (psign.astype(jnp.float32) * psig > 0)
                   & (jnp.abs(re - psig) > min_edge_amp))
        s0 = jnp.where(do & first, msign, s0)
        psign = jnp.where(do & (first | is_edge), msign, psign)
        emit = do & is_edge
        psig = jnp.where(do, re, psig)
        mst_out = mst
        mst = mst + do.astype(jnp.int32)
        return (s0, psign, psig, mst), (mst_out, start, emit)

    (sign0, prev_sign, prev_signal, ms_time), (ems, est, evalid) = \
        jax.lax.scan(body, (sign0, prev_sign, prev_signal, ms_time),
                     (means, starts, mask))
    return sign0, prev_sign, prev_signal, ms_time, ems, est, evalid


def _edge_scan(means: Array, starts: Array, mask: Array, locked: Array,
               min_edge_amp: Array, sign0, prev_sign, prev_signal, ms_time):
    """Bit-edge event detection (decodeData inner loop, gpslib.py:1421-1434)
    — VECTORIZED over the <=33 per-ms slots of one block.

    The sequential chain (an accepted edge changes the reference sign
    for subsequent ms) collapses to prefix ops because of an invariant:
    an edge can only be accepted at a CANDIDATE slot — one where the
    per-ms sign flips vs the previous slot's signal (msign[r] !=
    sign(psig[r]), psig nonzero, amplitude gate) — and after ANY
    candidate slot the chain's reference sign equals msign[r] whether
    the edge was accepted (psign := msign[r]) or rejected (rejection
    implies psign was already == msign[r]).  So the reference sign
    before slot r is simply msign at the LAST candidate before r (a
    cummax over position-encoded signs), and acceptance is
    candidate[r] & (that sign == sign(psig[r])).  Equivalence to the
    sequential form is pinned slot-for-slot by
    tests/test_edge_scan_equiv.py.
    """
    sl = means.shape[0]
    re = jnp.real(means)
    do = mask & locked
    doi = do.astype(jnp.int32)
    n_do = jnp.sum(doi)
    has = n_do > 0
    msign = jnp.where(re >= 0, 1, -1).astype(jnp.int8)
    psig = jnp.concatenate([prev_signal[None], re[:-1]])
    spm = jnp.where(psig >= 0, 1, -1).astype(jnp.int8)
    gate = jnp.abs(re - psig) > min_edge_amp
    r = jnp.arange(sl, dtype=jnp.int32)
    chain_started = sign0 != 0
    first_slot = (~chain_started) & (r == 0)
    cand = do & (msign != spm) & (psig != 0) & gate & (~first_slot)
    # reference sign before slot r: msign at the last candidate < r,
    # else the carried prev_sign (or msign[0] once the first do-slot
    # seeded the chain)
    base = jnp.where(chain_started, prev_sign, msign[0]).astype(jnp.int8)
    key = jnp.where(cand, 2 * (r + 1) + (msign > 0), 0)
    cum = jax.lax.cummax(key)
    cum_excl = jnp.concatenate([jnp.zeros((1,), key.dtype), cum[:-1]])
    psign_pre = jnp.where(cum_excl > 0,
                          jnp.where(cum_excl % 2 == 1, 1, -1),
                          base).astype(jnp.int8)
    accept = cand & (psign_pre == spm)

    cums = jnp.cumsum(doi)
    ems = ms_time + cums - doi            # mst BEFORE each slot
    est = starts
    new_ms = ms_time + n_do
    new_sign0 = jnp.where(chain_started | ~has, sign0, msign[0])
    last_key = cum[-1]
    psign_end = jnp.where(last_key > 0,
                          jnp.where(last_key % 2 == 1, 1, -1),
                          base).astype(jnp.int8)
    new_psign = jnp.where(has, psign_end, prev_sign)
    new_psig = jnp.where(
        has, jnp.sum(jnp.where(r == n_do - 1, re, 0.0)), prev_signal)
    return new_sign0, new_psign, new_psig, new_ms, ems, est, accept


def _pll(means: Array, mask: Array, n_valid: Array, locked: Array,
         df_buf: Array, df_cnt: Array, df_idx: Array, cfg: ReceiverConfig):
    """Carrier PLL (phaseLockedLoop, gpslib.py:1215-1262), vectorized.

    The reference's sequential pi-step unwrap becomes a cumulative sum of
    jump indicators; the DF drift history list becomes a ring buffer.
    """
    no_sec = cfg.no_sec
    max_df = jnp.float32(cfg.pll_max_df_per_sec / no_sec)
    ns = means.shape[0]
    # arctan(Q/I) like the reference — but a mean can be exactly 0+0j
    # (slot-0 of the block after a code-delay wrap through 0: no head
    # segment and an empty carry), and NaN from 0/0 would contaminate
    # the masked sums below (NaN*0 = NaN), latching freq to NaN.
    re_nz = means.real != 0
    phase = jnp.arctan(means.imag / jnp.where(re_nz, means.real, 1.0))
    phase = jnp.where(re_nz, phase,
                      jnp.sign(means.imag) * jnp.float32(np.pi / 2))
    deltas = jnp.diff(phase)
    dmask = (jnp.arange(1, ns) < n_valid)
    steps = jnp.where(dmask & (jnp.abs(deltas) > cfg.pll_phase_jump),
                      -jnp.sign(deltas), 0.0)
    real_phase = phase + jnp.concatenate(
        [jnp.zeros((1,), jnp.float32),
         jnp.cumsum(steps)]) * jnp.float32(np.pi)
    fmask = mask.astype(jnp.float32)
    nv = jnp.maximum(n_valid, 1).astype(jnp.float32)
    phase_dev = jnp.sum(real_phase * fmask) / nv
    tail = ((jnp.arange(ns) >= n_valid - cfg.pll_offset_avg)
            & mask).astype(jnp.float32)
    phase_offset = jnp.sum(real_phase * tail) / jnp.maximum(
        jnp.sum(tail), 1.0)

    mean_df = jnp.sum(df_buf) / jnp.maximum(df_cnt, 1).astype(jnp.float32)
    df_locked = jnp.clip(jnp.float32(cfg.pll_gain_locked) * phase_dev
                         + mean_df, -max_df, max_df)
    df_unlocked = jnp.float32(cfg.pll_gain_unlocked) * phase_dev
    df = jnp.where(locked, df_locked, df_unlocked)

    # locked: push df into the ring; unlocked: reset ring to [df].
    pos = jnp.where(df_cnt < no_sec, df_cnt, df_idx % no_sec)
    buf_locked = df_buf.at[pos].set(df)
    cnt_locked = jnp.minimum(df_cnt + 1, no_sec)
    idx_locked = jnp.where(df_cnt < no_sec, df_idx,
                           (df_idx + 1) % no_sec)
    buf_unlocked = jnp.zeros_like(df_buf).at[0].set(df)
    df_buf = jnp.where(locked, buf_locked, buf_unlocked)
    df_cnt = jnp.where(locked, cnt_locked, 1)
    df_idx = jnp.where(locked, idx_locked, 1)

    new_locked = locked | (jnp.abs(phase_dev) < cfg.pll_lock_threshold)
    return df, phase_offset, new_locked, df_buf, df_cnt, df_idx


def _corr_quality(found: Array, buf: Array, cnt: Array, idx: Array,
                  cfg: ReceiverConfig):
    """Correlation-quality history ring (corrQuality, gpslib.py:1331-1339)."""
    hist = cfg.corr_hist_len
    cpq = jnp.where(found, 1, -1).astype(jnp.int8)
    pos = jnp.where(cnt < hist, cnt, idx % hist)
    buf = buf.at[pos].set(cpq)
    cnt = jnp.minimum(cnt + 1, hist)
    idx = jnp.where(cnt < hist, idx, (idx + 1) % hist)
    corr_q = jnp.sum(buf, dtype=jnp.float32) / cnt.astype(jnp.float32)
    offs = jnp.arange(cfg.no_sec)
    last_pos = jnp.where(cnt < hist, cnt - 1 - offs, (idx - 1 - offs) % hist)
    lmask = offs < jnp.minimum(cnt, cfg.no_sec)
    vals = jnp.where(lmask, buf[jnp.clip(last_pos, 0, hist - 1)], 0)
    corr_l = jnp.sum(vals, dtype=jnp.float32) / jnp.maximum(
        jnp.sum(lmask), 1).astype(jnp.float32)
    return buf, cnt, idx, corr_q, corr_l


def channel_step(cfg: ReceiverConfig, state: ChannelState, block: Array,
                 stream_no: Array, code: Array,
                 code_fft: Array) -> tuple[ChannelState, ChannelOut]:
    """One 32 ms tracking step for one channel (vmap over channels).

    Mirror of SatStream.process's tracking branch (gpslib.py:1141-1210).
    """
    # 1. stream-skip detection (gpslib.py:1143-1146)
    skipped = stream_no - 1 != state.prev_stream
    erase = skipped & state.active
    sign0 = jnp.where(erase, jnp.int8(0), state.sign0)
    prev_sign = jnp.where(erase, jnp.int8(0), state.prev_sign)
    carry_sum = jnp.where(erase, jnp.complex64(0), state.carry_sum)
    carry_cnt = jnp.where(erase, 0, state.carry_cnt)

    # 2. Doppler wipeoff with continuous phase
    mixed, phase_end = dsp.doppler_mix(block, state.freq, state.phase,
                                       cfg.sample_rate)

    # 3. correlation on the center of the block
    first_seg = (cfg.n_cyc - cfg.corr_avg) // 2
    fft_mean = dsp.segment_fft_mean(mixed, cfg.code_samples, first_seg,
                                    cfg.corr_avg)
    corr = dsp.circ_correlate(fft_mean, code_fft)
    delay, code_phase, norm_max = dsp.peak_metrics(corr, cfg.corr_min)

    # 4. correlation quality history
    corr_buf, corr_cnt, corr_idx, corr_q, corr_l = _corr_quality(
        delay >= 0, state.corr_buf, state.corr_cnt, state.corr_idx, cfg)
    new_delay = jnp.where(delay >= 0, delay, state.delay)

    # 5. code wipeoff + per-ms means
    means, starts, mask, n_valid, carry_sum, carry_cnt = _decode_means(
        mixed, code_fft, new_delay, carry_sum, carry_cnt, cfg)

    # 6. bit-edge events (gate amplitude with the previous block's sigma,
    #    exactly as decodeData reads STD_DEV before process updates it)
    min_edge_amp = jnp.float32(cfg.edge_sigma) * state.std_dev
    sign0, prev_sign, prev_signal, ms_time, ems, est, evalid = _edge_scan(
        means, starts, mask, state.locked, min_edge_amp, sign0, prev_sign,
        state.prev_signal, state.ms_time)

    mag = jnp.abs(means)
    fmask = mask.astype(jnp.float32)
    nv = jnp.maximum(n_valid, 1).astype(jnp.float32)
    amp_mean = jnp.sum(mag * fmask) / nv
    std_dev = jnp.sqrt(jnp.maximum(
        jnp.sum(mag * mag * fmask) / nv - amp_mean * amp_mean, 1e-12))
    amplitude = amp_mean / std_dev

    # 7. PLL
    df, phase_offset, locked, df_buf, df_cnt, df_idx = _pll(
        means, mask, n_valid, state.locked, state.df_buf, state.df_cnt,
        state.df_idx, cfg)
    new_phase = jnp.remainder(phase_end + phase_offset,
                              jnp.float32(2 * np.pi))
    new_freq = jnp.clip(state.freq + df, cfg.min_freq, cfg.max_freq)

    sweep_request = ((corr_cnt >= cfg.corr_hist_len)
                     & (corr_q < cfg.min_corr_q) & state.active)

    computed = ChannelState(
        prn=state.prn, active=state.active, freq=new_freq, phase=new_phase,
        delay=new_delay, locked=locked, ms_time=ms_time, std_dev=std_dev,
        prev_stream=stream_no, prev_signal=prev_signal, sign0=sign0,
        prev_sign=prev_sign, carry_sum=carry_sum, carry_cnt=carry_cnt,
        df_buf=df_buf, df_cnt=df_cnt, df_idx=df_idx, corr_buf=corr_buf,
        corr_cnt=corr_cnt, corr_idx=corr_idx)
    # inactive slots: keep state frozen except the stream counter
    # (state.active is a scalar here — vmap supplies the channel axis)
    new_state = jax.tree.map(
        lambda c, s: jnp.where(state.active, c, s),
        computed, state._replace(prev_stream=stream_no))

    act = state.active
    out = ChannelOut(
        code_phase=jnp.where(act, code_phase, -1.0),
        delay=jnp.where(act, new_delay, 0),
        norm_max=jnp.where(act, norm_max, 0.0),
        amplitude=jnp.where(act, amplitude, 0.0),
        corr_q=jnp.where(act, corr_q, 0.0),
        corr_l=jnp.where(act, corr_l, 0.0),
        freq=jnp.where(act, new_freq, 0.0),
        locked=act & locked,
        erased=erase,
        sweep_request=sweep_request,
        sign0=jnp.where(act, sign0, jnp.int8(0)),
        edge_ms=ems, edge_local=est, edge_valid=evalid & act)
    return new_state, out


def track_chunk_impl(cfg: ReceiverConfig, states: ChannelState, blocks: Array,
                     stream_no0: Array, codes: Array,
                     code_ffts: Array) -> tuple[ChannelState, ChannelOut]:
    """Track all channels over a chunk of T consecutive blocks.

    blocks: complex64[T, ngps] or f32[T, ngps, 2] re/im pairs;
    stream_no0: stream number of blocks[0] as an int or f32 scalar
    (consecutive within the chunk — the host introduces skip gaps only at
    chunk boundaries, mirroring the reference's once-per-second cadence);
    codes: f32[n_channels, code_samples]; code_ffts: same shape rules as
    blocks.  All cross-boundary payloads are f32-representable (the
    host<->device boundary carries f32 only); ChannelOut leaves come back
    as f32 — use outs_to_numpy() on the host.

    Returns final states (device-resident pytree; never transfer it
    directly) and per-block outputs stacked on axis 0.
    """
    if cfg.cw_excision > 0:
        from gps_sdr.ops import frontend
        blocks = frontend.excise_cw_chunk(cfg, blocks)
        cfg = cfg.replace(cw_excision=0.0)      # callers below see clean
    blocks = as_complex(blocks)
    code_ffts = as_complex(code_ffts)
    stream0 = jnp.asarray(stream_no0).astype(jnp.int32)
    step = jax.vmap(
        functools.partial(channel_step, cfg),
        in_axes=(0, None, None, 0, 0), out_axes=0)

    t = blocks.shape[0]

    def body(carry, x):
        block, sno = x
        new_states, out = step(carry, block, sno, codes, code_ffts)
        return new_states, out

    stream_nos = stream0 + jnp.arange(t, dtype=jnp.int32)
    states, outs = jax.lax.scan(body, states, (blocks, stream_nos))
    outs = jax.tree.map(lambda x: x.astype(jnp.float32), outs)
    return states, outs


track_chunk = functools.partial(
    jax.jit, static_argnums=0, donate_argnums=(1,))(track_chunk_impl)


# ---------------------------------------------------------------------------
# K-block fused tracking step.
#
# The per-block feedback loop caps the scan at one block per step; on an
# accelerator the fixed per-step cost (kernel launches of a step's many
# small [C]-sized ops) then dominates.  The fused step processes K
# blocks per scan iteration with a restructuring of the PLL feedback:
#
#   * the mixer NCO is FROZEN for the K blocks (one factorized
#     oscillator over K*ngps samples, phase-continuous);
#   * the expensive stages — mixing, correlation, code wipeoff segment
#     sums — are batched over the K blocks (vmap, no feedback);
#   * the per-block PLL phase correction, which in the sequential form
#     re-phases the NCO before the next block, is instead applied as a
#     scalar rotation e^{-i dphi} of the next block's per-ms MEANS
#     (rotation commutes with the linear mean, so post-lock this is
#     exactly the sequential correction);
#   * frequency updates accumulate across the K blocks and are applied
#     to the NCO at the step boundary.  Within a step the frozen NCO
#     mistunes by at most the accumulated df (sub-Hz post-lock, bounded
#     by the reference's own 20 Hz/s slew limit, gpslib.py:1226-1229);
#     the residual ramp lands in the next phase offsets exactly like an
#     oscillator drift would.
#
# Semantics match channel_step at K=1 and post-lock differ from the
# sequential form only through the (sub-Hz) intra-step NCO mistuning.
#
# NO K LIMIT: the VIRTUAL NCO RETUNE in the body below applies the df
# already commanded within the step as a per-ms phase ramp on the
# means, so each block's PLL/df loop sees the residual mistuning
# exactly as the sequential loop's retuned NCO would — the frequency
# estimate converges to the sequential loop's value (within 0.02 Hz
# measured) at K = 8, 16, and 32, and decoded bits are identical
# (tests/test_tracking_batched.py).  Without it, every block of a step
# measures the SAME error against the frozen NCO and the summed
# corrections overshoot by up to K x.
# ---------------------------------------------------------------------------


class HeavyOut(NamedTuple):
    """Per-channel heavy-stage results for one K-block step."""

    delay_k: Array        # i32[k]; measured delay per block (-1 = miss)
    code_phase_k: Array   # f32[k]
    norm_max_k: Array     # f32[k]
    new_delay_k: Array    # i32[k]; miss -> previous block's delay
    head_k: Array         # c64[k]; wipeoff head sums
    seg_sums_k: Array     # c64[k, n_cyc]
    phase_end: Array      # f32; NCO phase after the k blocks
    wipe_delay: Array     # i32[k]; per-block wipeoff boundary delays


def predict_wipe_delays(cfg: ReceiverConfig, k: int, freq: Array,
                        delay0: Array) -> Array:
    """Per-block code-wipeoff boundary delays for a K-block step: i32[k].

    The code phase drifts with the code Doppler freq/1540 (the L1
    carrier is 1540x the 1.023 MHz chip rate) — ~0.13 samples per 32 ms
    block at 3 kHz carrier Doppler, i.e. > 1 chip across a K=32 step.
    A wipeoff frozen at the step-start delay therefore loses the decode
    means entirely late in a long step (measured: per-ms means die
    around block ~20, the PLL unwraps on noise, and the channel's
    frequency walks off).  Predicting the per-block drift from the
    tracked carrier frequency is exact to ~1e-3 samples/s, so the
    wipeoff stays aligned for any K.  Positive carrier Doppler
    compresses the code (delay decreases)."""
    drift = -(freq / jnp.float32(1540.0)) \
        * jnp.float32(cfg.code_samples / 1023.0) \
        * jnp.float32(cfg.ngps / cfg.sample_rate)
    j = jnp.arange(k, dtype=jnp.float32)
    w = delay0.astype(jnp.float32) + jnp.round(drift * j)
    return jnp.mod(w.astype(jnp.int32), cfg.code_samples)


def heavy_channel_k(cfg: ReceiverConfig, k: int, freq: Array, phase: Array,
                    delay0: Array, code_fft: Array,
                    blocks: Array) -> HeavyOut:
    """Heavy feedback-free stages of a K-block step for one channel:
    frozen-NCO mixing, per-block correlation, code-wipeoff segment sums.

    Code-wipeoff boundaries follow the predicted per-block code-Doppler
    drift (predict_wipe_delays) — the sequential loop's
    delay-measured-every-block semantics, made feedback-free.
    Pseudoranges use the correlator's code_phase, never the decode
    boundaries.
    """
    flat = blocks.reshape(k * cfg.ngps)
    mixed_flat, phase_end = dsp.doppler_mix(flat, freq, phase,
                                            cfg.sample_rate)
    mixed = mixed_flat.reshape(k, cfg.ngps)

    first_seg = (cfg.n_cyc - cfg.corr_avg) // 2

    def corr_one(m):
        fm = dsp.segment_fft_mean(m, cfg.code_samples, first_seg,
                                  cfg.corr_avg)
        corr = dsp.circ_correlate(fm, code_fft)
        return dsp.peak_metrics(corr, cfg.corr_min)

    delay_k, code_phase_k, norm_max_k = jax.vmap(corr_one)(mixed)

    # resolved delay per block (misses keep the previous block's delay)
    def res_delay(prev, d):
        nd = jnp.where(d >= 0, d, prev)
        return nd, nd

    _, new_delay_k = jax.lax.scan(res_delay, delay0, delay_k)

    wipe_k = predict_wipe_delays(cfg, k, freq, delay0)
    head_k, seg_sums_k = jax.vmap(
        lambda m, d: _segment_sums(m, code_fft, d, cfg))(mixed, wipe_k)
    return HeavyOut(delay_k, code_phase_k, norm_max_k, new_delay_k,
                    head_k, seg_sums_k, phase_end, wipe_k)


def heavy_stage(cfg: ReceiverConfig, k: int, states: ChannelState,
                blocks: Array, code_ffts: Array) -> HeavyOut:
    """Multi-channel heavy stage: heavy_channel_k vmapped over channels
    (the blocks are shared; XLA fuses the mix and wipeoff chains)."""
    return jax.vmap(
        functools.partial(heavy_channel_k, cfg, k),
        in_axes=(0, 0, 0, 0, None))(
            states.freq, states.phase, states.delay, code_ffts, blocks)


def channel_step_k(cfg: ReceiverConfig, k: int, state: ChannelState,
                   heavy: HeavyOut, stream_no0: Array
                   ) -> tuple[ChannelState, ChannelOut]:
    """Cheap per-channel feedback for one K-block step (vmap over
    channels): means assembly, phase-rotation PLL, bit edges, rings.

    Takes the heavy stage's results (heavy_stage / heavy_channel_k);
    returns (new_state, outs with leading axis k).
    """
    (delay_k, code_phase_k, norm_max_k, new_delay_k, head_k, seg_sums_k,
     phase_end, wipe_k) = heavy

    # stream-skip detection for the step's first block (gaps are only
    # introduced at chunk boundaries, runtime/receiver.py)
    skipped = stream_no0 - 1 != state.prev_stream
    erase = skipped & state.active
    sign0_in = jnp.where(erase, jnp.int8(0), state.sign0)
    prev_sign_in = jnp.where(erase, jnp.int8(0), state.prev_sign)
    carry_sum_in = jnp.where(erase, jnp.complex64(0), state.carry_sum)
    carry_cnt_in = jnp.where(erase, 0, state.carry_cnt)

    # ---- cheap per-block feedback (means -> edges -> PLL), scanned ----
    t_blk = jnp.float32(cfg.ngps / cfg.sample_rate)
    two_pi = jnp.float32(2 * np.pi)

    def body(carry, x):
        (dphi, carry_sum, carry_cnt, sign0, prev_sign, prev_signal,
         ms_time, std_dev, locked, df_sum, df_buf, df_cnt, df_idx,
         corr_buf, corr_cnt, corr_idx) = carry
        head, seg_sums, found, wipe_b = x

        means, starts, mask, n_valid, carry_sum, carry_cnt = \
            _means_from_sums(head, seg_sums, wipe_b, carry_sum,
                             carry_cnt, cfg)
        # VIRTUAL NCO RETUNE: the real NCO is frozen for the whole step,
        # so every block would measure the SAME frequency error and the
        # summed per-block df corrections overshoot by up to k x (a
        # fresh channel 100 Hz off gets a -800 Hz step at k=8).  Apply
        # the df already commanded this step (df_sum) as a per-ms phase
        # ramp on the means — each block's PLL then sees the residual,
        # exactly like the sequential loop's retuned NCO; dphi below
        # accumulates the virtual phase advance to keep the real NCO
        # phase-continuous at the step boundary.
        t_m = (starts.astype(jnp.float32)
               + jnp.float32(0.5 * cfg.code_samples)) \
            / jnp.float32(cfg.sample_rate)
        ang = dphi + two_pi * df_sum * t_m
        means = means * jax.lax.complex(jnp.cos(ang), -jnp.sin(ang))

        corr_buf, corr_cnt, corr_idx, corr_q, corr_l = _corr_quality(
            found, corr_buf, corr_cnt, corr_idx, cfg)

        min_edge_amp = jnp.float32(cfg.edge_sigma) * std_dev
        sign0, prev_sign, prev_signal, ms_time, ems, est, evalid = \
            _edge_scan(means, starts, mask, locked, min_edge_amp, sign0,
                       prev_sign, prev_signal, ms_time)

        mag = jnp.abs(means)
        fmask = mask.astype(jnp.float32)
        nv = jnp.maximum(n_valid, 1).astype(jnp.float32)
        amp_mean = jnp.sum(mag * fmask) / nv
        std_dev = jnp.sqrt(jnp.maximum(
            jnp.sum(mag * mag * fmask) / nv - amp_mean * amp_mean, 1e-12))
        amplitude = amp_mean / std_dev

        df, phase_offset, locked, df_buf, df_cnt, df_idx = _pll(
            means, mask, n_valid, locked, df_buf, df_cnt, df_idx, cfg)
        # virtual phase advance of the intra-step retune over this block
        dphi = dphi + phase_offset + two_pi * df_sum * t_blk
        df_sum = df_sum + df

        carry = (dphi, carry_sum, carry_cnt, sign0, prev_sign, prev_signal,
                 ms_time, std_dev, locked, df_sum, df_buf, df_cnt, df_idx,
                 corr_buf, corr_cnt, corr_idx)
        return carry, (amplitude, corr_q, corr_l, locked, sign0,
                       ems, est, evalid)

    carry0 = (jnp.float32(0), carry_sum_in, carry_cnt_in, sign0_in,
              prev_sign_in, state.prev_signal, state.ms_time,
              state.std_dev, state.locked, jnp.float32(0), state.df_buf,
              state.df_cnt, state.df_idx, state.corr_buf, state.corr_cnt,
              state.corr_idx)
    carry, outs = jax.lax.scan(
        body, carry0, (head_k, seg_sums_k, delay_k >= 0, wipe_k))
    (dphi, carry_sum, carry_cnt, sign0, prev_sign, prev_signal, ms_time,
     std_dev, locked, df_sum, df_buf, df_cnt, df_idx, corr_buf, corr_cnt,
     corr_idx) = carry
    (amp_seq, corr_q_seq, corr_l_seq, locked_seq, sign0_seq,
     ems, est, evalid) = outs

    # The step's accumulated PLL correction dphi folds into the NCO phase
    # below, so the NEXT step's mixed samples arrive already de-rotated —
    # but the stored carry tail was accumulated under THIS step's frozen
    # NCO and is still raw.  De-rotate it now, else the next step's
    # carry-completed mean0 is mis-rotated by a full step of dphi
    # (~k*2pi*df*t_blk, order pi at K=16 with ~1 Hz mistuning), its sign
    # flips, and the edge detector emits a spurious edge pair that
    # desyncs the 20 ms bit framing.
    carry_sum = carry_sum * jax.lax.complex(jnp.cos(dphi), -jnp.sin(dphi))

    new_freq = jnp.clip(state.freq + df_sum, cfg.min_freq, cfg.max_freq)
    new_phase = jnp.remainder(phase_end + dphi, jnp.float32(2 * np.pi))
    sweep_request = ((corr_cnt >= cfg.corr_hist_len)
                     & (corr_q_seq[-1] < cfg.min_corr_q) & state.active)

    computed = ChannelState(
        prn=state.prn, active=state.active, freq=new_freq, phase=new_phase,
        delay=new_delay_k[-1], locked=locked, ms_time=ms_time,
        std_dev=std_dev, prev_stream=stream_no0 + k - 1,
        prev_signal=prev_signal, sign0=sign0, prev_sign=prev_sign,
        carry_sum=carry_sum, carry_cnt=carry_cnt, df_buf=df_buf,
        df_cnt=df_cnt, df_idx=df_idx, corr_buf=corr_buf,
        corr_cnt=corr_cnt, corr_idx=corr_idx)
    new_state = jax.tree.map(
        lambda c, s: jnp.where(state.active, c, s),
        computed, state._replace(prev_stream=stream_no0 + k - 1))

    act = state.active
    ksl = (k,)
    out = ChannelOut(
        code_phase=jnp.where(act, code_phase_k, -1.0),
        delay=jnp.where(act, new_delay_k, 0),
        norm_max=jnp.where(act, norm_max_k, 0.0),
        amplitude=jnp.where(act, amp_seq, 0.0),
        corr_q=jnp.where(act, corr_q_seq, 0.0),
        corr_l=jnp.where(act, corr_l_seq, 0.0),
        freq=jnp.where(act, jnp.broadcast_to(new_freq, ksl), 0.0),
        locked=act & locked_seq,
        erased=jnp.concatenate([erase[None],
                                jnp.zeros((k - 1,), bool)]) if k > 1
        else erase[None],
        sweep_request=jnp.broadcast_to(sweep_request, ksl) &
        (jnp.arange(k) == k - 1),
        sign0=jnp.where(act, sign0_seq, jnp.int8(0)),
        edge_ms=ems, edge_local=est, edge_valid=evalid & act)
    return new_state, out


def track_chunk_batched_impl(cfg: ReceiverConfig, states: ChannelState,
                             blocks: Array, stream_no0: Array, codes: Array,
                             code_ffts: Array
                             ) -> tuple[ChannelState, ChannelOut]:
    """track_chunk with cfg.blocks_per_step blocks fused per scan step.

    Same contract as track_chunk_impl; T must be divisible by
    cfg.blocks_per_step.  Outputs come back in stream order [T, C, ...].
    """
    if cfg.cw_excision > 0:
        from gps_sdr.ops import frontend
        blocks = frontend.excise_cw_chunk(cfg, blocks)
        cfg = cfg.replace(cw_excision=0.0)      # inner calls see clean
    k = cfg.blocks_per_step
    if k <= 1:
        return track_chunk_impl(cfg, states, blocks, stream_no0, codes,
                                code_ffts)
    t = blocks.shape[0]
    if t % k:
        # remainder tail (a partial final chunk or a skip-forced chunk
        # boundary, runtime/receiver.py): fused steps over the divisible
        # prefix, the K=1 sequential scan over the tail — shapes are
        # static, so both programs live in the same jit
        tm = t - t % k
        if tm == 0:
            st, outs = track_chunk_impl(cfg, states, blocks, stream_no0,
                                        codes, code_ffts)
            return st, jax.tree.map(
                lambda x: x.astype(jnp.float32), outs)
        st1, o1 = track_chunk_batched_impl(cfg, states, blocks[:tm],
                                           stream_no0, codes, code_ffts)
        st2, o2 = track_chunk_impl(cfg, st1, blocks[tm:],
                                   jnp.asarray(stream_no0) + tm, codes,
                                   code_ffts)
        outs = jax.tree.map(
            lambda a, b: jnp.concatenate(
                [a, b.astype(jnp.float32)], axis=0), o1, o2)
        return st2, outs
    blocks = as_complex(blocks)
    code_ffts = as_complex(code_ffts)
    stream0 = jnp.asarray(stream_no0).astype(jnp.int32)
    cheap = jax.vmap(functools.partial(channel_step_k, cfg, k),
                     in_axes=(0, 0, None), out_axes=0)

    def body(carry, x):
        blk, sno = x
        with jax.named_scope("heavy"):
            heavy = heavy_stage(cfg, k, carry, blk, code_ffts)
        with jax.named_scope("cheap"):
            return cheap(carry, heavy, sno)

    lead = blocks.reshape((t // k, k) + blocks.shape[1:])
    stream_nos = stream0 + k * jnp.arange(t // k, dtype=jnp.int32)
    states, outs = jax.lax.scan(body, states, (lead, stream_nos))

    # [T//k, C, k, ...] -> [T, C, ...]
    def flat(x):
        x = jnp.moveaxis(x, 2, 1)       # [T//k, k, C, ...]
        return x.reshape((t,) + x.shape[2:]).astype(jnp.float32)

    outs = jax.tree.map(flat, outs)
    return states, outs


track_chunk_batched = functools.partial(
    jax.jit, static_argnums=0, donate_argnums=(1,))(track_chunk_batched_impl)


def track_streams_impl(cfg: ReceiverConfig, states: ChannelState,
                       blocks: Array, stream_no0: Array, codes: Array,
                       code_ffts: Array) -> tuple[ChannelState, ChannelOut]:
    """Track S independent IQ streams, each with its own channel set, in
    one device program (production serving: many receivers per chip).

    Every argument gains a leading stream axis: states leaves [S, C, ..],
    blocks [S, T, ngps] (or f32 pairs), codes/code_ffts [S, C, cs].
    stream_no0 broadcasts or is [S].  Semantics per stream are identical
    to track_chunk_batched.
    """
    s0 = jnp.broadcast_to(jnp.asarray(stream_no0),
                          (blocks.shape[0],))
    return jax.vmap(
        lambda st, b, n0, cd, ff: track_chunk_batched_impl(
            cfg, st, b, n0, cd, ff))(states, blocks, s0, codes, code_ffts)


track_streams = functools.partial(
    jax.jit, static_argnums=0, donate_argnums=(1,))(track_streams_impl)


_OUT_DTYPES = {
    "delay": np.int32, "locked": bool, "erased": bool,
    "sweep_request": bool, "sign0": np.int8, "edge_ms": np.int32,
    "edge_local": np.int32, "edge_valid": bool,
}


# f32 packing is integer-exact only below 2^24; edge_ms counts ms since
# lock and exceeds that after ~4.66 h of continuous lock, so it crosses
# as two planes (hi = ms >> 12, lo = ms & 0xfff — both far below 2^24)
_EDGE_MS_SPLIT = 4096


@jax.jit
def pack_outs(outs: ChannelOut) -> Array:
    """Pack a ChannelOut into ONE f32 buffer [..., C, F] for download.

    Every downloaded array pays a fixed per-transfer cost; one packed
    transfer pays it once instead of once per field.  Fields
    may carry extra leading batch axes (e.g. track_streams' stream
    axis); everything left of the edge axis is treated as batch."""
    cols = []
    for name in ChannelOut._fields:
        v = getattr(outs, name)
        if name == "edge_ms":
            v = v.astype(jnp.int32)
            cols.append((v // _EDGE_MS_SPLIT).astype(jnp.float32))
            cols.append((v % _EDGE_MS_SPLIT).astype(jnp.float32))
            continue
        v = v.astype(jnp.float32)
        cols.append(v if name.startswith("edge_") else v[..., None])
    return jnp.concatenate(cols, axis=-1)


def unpack_outs(buf: np.ndarray, n_edge: int) -> ChannelOut:
    """Host-side inverse of pack_outs (buf already a numpy array)."""
    host = {}
    off = 0
    for name in ChannelOut._fields:
        if name == "edge_ms":
            hi = buf[..., off:off + n_edge]
            lo = buf[..., off + n_edge:off + 2 * n_edge]
            off += 2 * n_edge
            host[name] = (np.rint(hi).astype(np.int64) * _EDGE_MS_SPLIT
                          + np.rint(lo).astype(np.int64)).astype(np.int32)
            continue
        w = n_edge if name.startswith("edge_") else 1
        v = buf[..., off:off + w]
        off += w
        if w == 1:
            v = v[..., 0]
        dt = _OUT_DTYPES.get(name)
        if dt is bool:
            v = v > 0.5
        elif dt is not None:
            v = np.rint(v).astype(dt)
        host[name] = v
    return ChannelOut(**host)


def outs_to_numpy(outs: ChannelOut) -> ChannelOut:
    """Fetch a ChannelOut to the host (one packed transfer) and
    restore natural dtypes."""
    n_edge = outs.edge_ms.shape[-1]
    return unpack_outs(np.asarray(pack_outs(outs)), n_edge)


def cn0_from_amp(amp, code_period_hz: float = 1000.0):
    """Carrier-to-noise density C/N0 [dB-Hz] from the tracker's
    amplitude ratio AMP = mean|m| / std|m| of the 1 ms coherent prompt
    sums (the figure the reference reports raw and never calibrates,
    reportValues, src/gpslib.py:1124-1131).

    With m = A + n, per-component noise sigma s: E|m|^2 = A^2 + 2 s^2
    and Var|m| ~= s^2 at tracking SNRs, so A^2/s^2 = AMP^2 - 1 and
    C/N0 = (A^2 / (2 s^2)) * code_period_hz.  Per-block estimates
    carry ~1-2 dB of scatter from the 32-sample std; average over a
    few seconds for display-grade numbers."""
    amp = np.asarray(amp, np.float64)
    snr = np.maximum(amp * amp - 1.0, 1e-2)
    return 10.0 * np.log10(snr * 0.5 * code_period_hz)


# --- compact transport (run_device streaming) -------------------------------
#
# The full pack_outs buffer is [T, C, ~143] f32 (~220 KB/s-chunk at 12
# channels), most of it dense edge planes.  But the host only
# consumes per BLOCK: code_phase, sign0, erased; per CHUNK: the last
# block's amplitude/corr_q/corr_l/freq/locked/norm_max/sweep_request;
# and the SPARSE bit-edge events (<= 50/s/channel at the 20 ms bit
# length, vs a [T, n_cyc+1] dense plane).  pack_outs_compact ships
# exactly that (~20 KB/s-chunk): dense per-block triple + last-block
# row + edge events compacted by an on-device lax.sort (no gathers).
# unpack_outs_compact scatters the events back into dense planes on the
# host, so the receiver's consume path is unchanged and bit-exact
# unless a channel exceeds `cap` edges (counted, never silent).

_LAST_FIELDS = ("amplitude", "corr_q", "corr_l", "freq", "locked",
                "norm_max", "sweep_request")


@functools.partial(jax.jit, static_argnums=(1, 2))
def pack_outs_compact(outs: ChannelOut, cap: int,
                      with_freq: bool = False) -> Array:
    """Pack one chunk's ChannelOut into a flat f32[L] transport buffer.

    Layout: [T*C*nb per-block | C*7 last-block | C*2 ms base (hi/lo) |
    C*cap*3 edges | C counts].  Per-block columns are (code_phase,
    sign0+1 + 4*erased[, freq if with_freq — carrier smoothing]).
    Edge entries are (flat_pos, ms - base, local)
    sorted by flat_pos = block*(n_cyc+1)+slot with -1 sentinels past
    the valid count; base is the channel's first edge ms, so the delta
    is integer-exact in f32 for any chunk shorter than ~4.6 h while the
    absolute counter crosses as a hi/lo pair."""
    t, c, sl = outs.edge_valid.shape
    d = t * sl
    cap = min(cap, d)
    f32 = jnp.float32

    aux = (outs.sign0.astype(f32) + 1.0
           + 4.0 * outs.erased.astype(f32))
    cols = [outs.code_phase.astype(f32), aux]
    if with_freq:
        # per-block carrier freq rides along (3rd column):
        # carrier-smoothed pseudoranges (models/pseudorange.py Hatch
        # filter) need the tracked Doppler per block, not just the
        # last-block report
        cols.append(outs.freq.astype(f32))
    blocky = jnp.stack(cols, axis=-1)                   # [T, C, 2 or 3]
    last = jnp.stack([getattr(outs, n)[-1].astype(f32)
                      for n in _LAST_FIELDS], axis=-1)       # [C, 7]

    valid = jnp.moveaxis(outs.edge_valid, 1, 0).reshape(c, d)
    ms = jnp.moveaxis(outs.edge_ms, 1, 0).reshape(c, d).astype(jnp.int32)
    loc = jnp.moveaxis(outs.edge_local, 1, 0).reshape(c, d) \
        .astype(jnp.int32)
    pos = jnp.broadcast_to(jnp.arange(d, dtype=jnp.int32), (c, d))
    key = jnp.where(valid, pos, d)
    skey, sms, sloc = jax.lax.sort((key, ms, loc), dimension=-1,
                                   num_keys=1)
    skey, sms, sloc = skey[:, :cap], sms[:, :cap], sloc[:, :cap]
    ok = skey < d
    base = sms[:, 0] * ok[:, 0].astype(jnp.int32)            # [C]
    base_hi = (base // _EDGE_MS_SPLIT).astype(f32)
    base_lo = (base % _EDGE_MS_SPLIT).astype(f32)
    edges = jnp.stack([
        jnp.where(ok, skey, -1).astype(f32),
        jnp.where(ok, sms - base[:, None], 0).astype(f32),
        jnp.where(ok, sloc, 0).astype(f32)], axis=-1)        # [C, cap, 3]
    nv = jnp.sum(valid.astype(f32), axis=-1)                 # [C]
    return jnp.concatenate([blocky.reshape(-1), last.reshape(-1),
                            base_hi, base_lo, edges.reshape(-1), nv])


def unpack_outs_compact(buf: np.ndarray, t: int, c: int, sl: int,
                        cap: int,
                        with_freq: bool = False
                        ) -> tuple[ChannelOut, np.ndarray]:
    """Host inverse of pack_outs_compact: rebuild a dense ChannelOut
    (dropped fields zero-filled; last-block fields broadcast over T —
    the consume path only reads their [-1] row).  Returns (outs,
    n_dropped_edges[c])."""
    cap = min(cap, t * sl)
    nb = 3 if with_freq else 2
    off = 0
    blocky = buf[off:off + t * c * nb].reshape(t, c, nb)
    off += t * c * nb
    last = buf[off:off + c * 7].reshape(c, 7)
    off += c * 7
    base = (np.rint(buf[off:off + c]).astype(np.int64) * _EDGE_MS_SPLIT
            + np.rint(buf[off + c:off + 2 * c]).astype(np.int64))
    off += 2 * c
    edges = buf[off:off + c * cap * 3].reshape(c, cap, 3)
    off += c * cap * 3
    nv = np.rint(buf[off:off + c]).astype(np.int64)

    edge_ms = np.zeros((t, c, sl), np.int32)
    edge_local = np.zeros((t, c, sl), np.int32)
    edge_valid = np.zeros((t, c, sl), bool)
    pos = np.rint(edges[..., 0]).astype(np.int64)            # [C, cap]
    ch, pe = np.nonzero(pos >= 0)
    if ch.size:
        fp = pos[ch, pe]
        tb, es = fp // sl, fp % sl
        edge_ms[tb, ch, es] = (base[ch]
                               + np.rint(edges[ch, pe, 1]).astype(np.int64)
                               ).astype(np.int32)
        edge_local[tb, ch, es] = np.rint(edges[ch, pe, 2]).astype(np.int32)
        edge_valid[tb, ch, es] = True

    lastv = {n: np.broadcast_to(last[:, i], (t, c)) for i, n in
             enumerate(_LAST_FIELDS)}
    aux = np.rint(blocky[..., 1]).astype(np.int8)
    outs = ChannelOut(
        code_phase=blocky[..., 0],
        delay=np.zeros((t, c), np.int32),
        norm_max=lastv["norm_max"],
        amplitude=lastv["amplitude"],
        corr_q=lastv["corr_q"],
        corr_l=lastv["corr_l"],
        freq=(blocky[..., 2] if with_freq   # per-block: Hatch input
              else lastv["freq"]),
        locked=lastv["locked"] > 0.5,
        erased=aux >= 4,
        sweep_request=lastv["sweep_request"] > 0.5,
        sign0=(aux % 4 - 1).astype(np.int8),
        edge_ms=edge_ms, edge_local=edge_local, edge_valid=edge_valid)
    return outs, np.maximum(nv - cap, 0)


class CompactWindow(NamedTuple):
    """Host view of a whole download window's packed transport rows
    WITHOUT the dense edge-plane scatter.

    unpack_outs_compact rebuilds [T, C, n_cyc+1] dense edge planes that
    the nav decoder immediately re-sparsifies (push_chunk) — at serving
    scale that round trip plus the per-chunk unpack loop was a
    measurable slice of the host consume budget.  This view keeps the
    edges sparse exactly as packed (sorted by flat block*sl+slot) and
    slices the whole [w, L] window in one pass."""

    code_phase: np.ndarray        # [w*t, C] f32
    aux: np.ndarray               # [w*t, C] int8: sign0+1 + 4*erased
    freq: np.ndarray | None       # [w*t, C] f32 (with_freq only)
    last: np.ndarray              # [w, C, 7] f32, _LAST_FIELDS columns
    edge_pos: np.ndarray          # [w, C, cap] int64 flat pos, -1 pad
    edge_ms: np.ndarray           # [w, C, cap] int64 absolute ms
    edge_local: np.ndarray        # [w, C, cap] int32 sample-in-block
    dropped: np.ndarray           # [w, C] int64 edges past cap


# _LAST_FIELDS column indices (CompactWindow.last[..., i])
_LAST_IDX = {n: i for i, n in enumerate(_LAST_FIELDS)}


def unpack_window_compact(rows: np.ndarray, t: int, c: int, sl: int,
                          cap: int,
                          with_freq: bool = False) -> CompactWindow:
    """One host pass over a window's packed rows [w, L] (layout:
    pack_outs_compact) -> CompactWindow."""
    rows = np.asarray(rows)
    w = rows.shape[0]
    cap = min(cap, t * sl)
    nb = 3 if with_freq else 2
    off = t * c * nb
    blocky = rows[:, :off].reshape(w, t, c, nb)
    last = rows[:, off:off + c * 7].reshape(w, c, 7)
    off += c * 7
    base = (np.rint(rows[:, off:off + c]).astype(np.int64)
            * _EDGE_MS_SPLIT
            + np.rint(rows[:, off + c:off + 2 * c]).astype(np.int64))
    off += 2 * c
    edges = rows[:, off:off + c * cap * 3].reshape(w, c, cap, 3)
    off += c * cap * 3
    nv = np.rint(rows[:, off:off + c]).astype(np.int64)
    pos = np.rint(edges[..., 0]).astype(np.int64)
    ms = base[:, :, None] + np.rint(edges[..., 1]).astype(np.int64)
    return CompactWindow(
        code_phase=blocky[..., 0].reshape(w * t, c),
        aux=np.rint(blocky[..., 1]).astype(np.int8).reshape(w * t, c),
        freq=(blocky[..., 2].reshape(w * t, c) if with_freq else None),
        last=last, edge_pos=pos, edge_ms=ms,
        edge_local=np.rint(edges[..., 2]).astype(np.int32),
        dropped=np.maximum(nv - cap, 0))


# ChannelState leaf dtypes (for the f32-safe checkpoint pack below)
_STATE_DTYPES = {
    "prn": jnp.int32, "active": bool, "freq": jnp.float32,
    "phase": jnp.float32, "delay": jnp.int32, "locked": bool,
    "ms_time": jnp.int32, "std_dev": jnp.float32,
    "prev_stream": jnp.int32, "prev_signal": jnp.float32,
    "sign0": jnp.int8, "prev_sign": jnp.int8,
    "carry_sum": jnp.complex64, "carry_cnt": jnp.int32,
    "df_buf": jnp.float32, "df_cnt": jnp.int32, "df_idx": jnp.int32,
    "corr_buf": jnp.int8, "corr_cnt": jnp.int32, "corr_idx": jnp.int32,
}
# counters that can exceed f32's 2^24 integer-exact range on long runs
# (ms_time after ~4.66 h of lock; prev_stream after ~6 days of stream)
_STATE_SPLIT = {"ms_time", "prev_stream"}
_SPLIT_BASE = 4096


@jax.jit
def pack_states(states: ChannelState) -> dict:
    """ChannelState -> dict of f32 arrays for an exact trip through the
    f32-only transfer boundary (checkpointing; runtime/checkpoint.py).
    Complex leaves split into re/im, large counters into hi/lo."""
    out = {}
    for name, v in states._asdict().items():
        if v.dtype == jnp.complex64:
            out[name + "__re"] = jnp.real(v)
            out[name + "__im"] = jnp.imag(v)
        elif name in _STATE_SPLIT:
            v = v.astype(jnp.int32)
            out[name + "__hi"] = (v // _SPLIT_BASE).astype(jnp.float32)
            out[name + "__lo"] = (v % _SPLIT_BASE).astype(jnp.float32)
        else:
            out[name] = v.astype(jnp.float32)
    return out


@jax.jit
def unpack_states(tree: dict) -> ChannelState:
    """Inverse of pack_states (accepts jnp or np f32 arrays)."""
    fields = {}
    for name, dt in _STATE_DTYPES.items():
        if dt == jnp.complex64:
            fields[name] = jax.lax.complex(
                jnp.asarray(tree[name + "__re"]),
                jnp.asarray(tree[name + "__im"]))
        elif name in _STATE_SPLIT:
            hi = jnp.round(jnp.asarray(tree[name + "__hi"]))
            lo = jnp.round(jnp.asarray(tree[name + "__lo"]))
            fields[name] = (hi.astype(jnp.int32) * _SPLIT_BASE
                            + lo.astype(jnp.int32))
        elif dt is bool:
            fields[name] = jnp.asarray(tree[name]) > 0.5
        elif dt == jnp.float32:
            fields[name] = jnp.asarray(tree[name])
        else:
            fields[name] = jnp.round(jnp.asarray(tree[name])).astype(dt)
    return ChannelState(**fields)


@functools.partial(jax.jit, static_argnums=0)
def summarize_states(cfg: ReceiverConfig, states: ChannelState) -> dict:
    """f32 view of the per-channel state for host-side policy/reporting
    (the transfer boundary carries f32 only)."""
    return {
        "prn": states.prn.astype(jnp.float32),
        "active": states.active.astype(jnp.float32),
        "freq": states.freq,
        "delay": states.delay.astype(jnp.float32),
        "locked": states.locked.astype(jnp.float32),
        "ms_time": states.ms_time.astype(jnp.float32),
        "amplitude_sigma": states.std_dev,
        "corr_cnt": states.corr_cnt.astype(jnp.float32),
    }


# --- fused download-window dispatch ------------------------------------------
#
# Every dispatched program pays a fixed host-side cost, and the per-chunk
# loop dispatches 4 programs per chunk (provider slice, stream broadcast,
# track_streams, pack).  The window programs below run a WHOLE download
# window — w chunks of t blocks — as one jitted scan that tracks and
# packs each chunk, returning the stacked transport buffer [w(, S), L]
# the drain path already consumes.  One dispatch per window instead of
# 4w.


def track_window_impl(cfg: ReceiverConfig, states: ChannelState,
                      blocks: Array, stream_no0: Array, codes: Array,
                      code_ffts: Array, cap: int,
                      with_freq: bool = False
                      ) -> tuple[ChannelState, Array]:
    """Track + pack a window of w chunks in one program (one stream).

    blocks [w, t, *iq]; returns (states, packed f32[w, L]) where row i
    is pack_outs_compact of chunk i tracked at stream_no0 + i*t.
    """
    w, t = blocks.shape[0], blocks.shape[1]

    def body(st, x):
        blk, i = x
        st, outs = track_chunk_batched_impl(
            cfg, st, blk, jnp.asarray(stream_no0) + i * t, codes,
            code_ffts)
        return st, pack_outs_compact(outs, cap, with_freq)

    return jax.lax.scan(body, states,
                        (blocks, jnp.arange(w, dtype=jnp.int32)))


track_window = functools.partial(
    jax.jit, static_argnums=(0, 6, 7),
    donate_argnums=(1,))(track_window_impl)


def track_streams_window_impl(cfg: ReceiverConfig, states: ChannelState,
                              blocks: Array, stream_no0: Array,
                              codes: Array, code_ffts: Array, cap: int,
                              with_freq: bool = False,
                              shared: bool = True
                              ) -> tuple[ChannelState, Array]:
    """Track + pack a window of w chunks for S streams in one program.

    shared=True (serving replicas of one capture): blocks [w, t, *iq],
    broadcast over the stream axis per chunk.  shared=False
    (independent front ends): blocks [w, S, t, *iq].  Returns (states,
    packed f32[w, S, L]) — the _stack_windows layout StreamServer's
    drain already unpacks.
    """
    t = blocks.shape[1] if shared else blocks.shape[2]
    w = blocks.shape[0]
    s_n = states.prn.shape[0]

    def body(st, x):
        blk, i = x
        if shared:
            blk = jnp.broadcast_to(blk[None], (s_n,) + blk.shape)
        st, outs = track_streams_impl(cfg, st, blk,
                                      jnp.asarray(stream_no0) + i * t,
                                      codes, code_ffts)
        packed = jax.vmap(
            lambda o: pack_outs_compact(o, cap, with_freq))(outs)
        return st, packed

    return jax.lax.scan(body, states,
                        (blocks, jnp.arange(w, dtype=jnp.int32)))


track_streams_window = functools.partial(
    jax.jit, static_argnums=(0, 6, 7, 8),
    donate_argnums=(1,))(track_streams_window_impl)
