"""Sharded tracking: channels over ``ch``, stream time over ``time``.

Channel axis (SURVEY.md P1): the reference ran one satellite per OS
process with pickled 512 KB blocks fanned out through mp.Queues
(src/gpsrecv.py:300-417).  Here channels are a sharded batch axis of the
vmapped tracking step — zero serialization, no collectives on the hot
path.

Time axis (SURVEY.md P5 — the new capability): the reference processes
32 ms blocks strictly sequentially because per-channel carry state
(PREV_SAMPLES tail, PLL phase/freq, bit-edge signs, gpslib.py:1056-1062)
crosses every block boundary.  Here a long stream is split into
contiguous time shards; each shard scans its blocks locally, then the
shard-final states are passed to the right neighbor with
``lax.ppermute`` and the scan re-runs (`n_stitch` passes).  After k
passes, shards 0..k-1 have exact sequential-equivalent carry state; later
shards start from a k-hop-stitched state, which the tracking loops
forgive quickly (the PLL re-locks within a few blocks; the stream-skip
eraser, gpslib.py:1143-46, resets bit continuity on pass-1 cold starts
automatically because prev_stream mismatches).  n_stitch = n_time_shards
reproduces the sequential result exactly.

The host-side epoch pipeline consumes the stacked per-block outputs in
stream order, so decode/PVT are agnostic to how tracking was sharded.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gps_sdr.config import ReceiverConfig
from gps_sdr.ops.tracking import (ChannelOut, ChannelState,
                                  track_chunk_impl)
from gps_sdr.parallel.mesh import CH_AXIS, TIME_AXIS


def pad_channels(states: ChannelState, codes: np.ndarray,
                 code_ffts: np.ndarray, mult: int):
    """Pad the channel axis up to a multiple of the ch mesh-axis size.

    Padded slots are inactive (prn=0), mirroring the reference's empty
    worker slots (gpsrecv.py:358-359)."""
    c = int(np.asarray(states.prn).shape[0])
    rem = (-c) % mult
    if rem == 0:
        return states, codes, code_ffts
    pad = lambda x: jnp.concatenate(
        [jnp.asarray(x), jnp.zeros((rem,) + x.shape[1:], x.dtype)])
    states = jax.tree.map(pad, states)
    codes = np.concatenate(
        [codes, np.zeros((rem,) + codes.shape[1:], codes.dtype)])
    code_ffts = np.concatenate(
        [code_ffts, np.zeros((rem,) + code_ffts.shape[1:], code_ffts.dtype)])
    return states, codes, code_ffts


def _track_shard(cfg: ReceiverConfig, n_time: int, n_stitch: int,
                 warmup: int, states0: ChannelState, blocks, stream_no0,
                 codes, code_ffts):
    """Per-device body: scan local blocks over local channels, stitching
    carry state across time shards with ppermute.

    Two stitch strategies (see track_sharded):
      * full re-scan passes (n_stitch): pass k makes shards 0..k-1
        exact; n_stitch = n_time is sequential-exact but re-processes
        the whole stream on every device (zero speedup at exactness).
      * boundary-state handoff (warmup > 0): ONE ppermute of the
        shard-final carry pytree (a few KB/channel) plus a re-scan of
        only the first `warmup` blocks.  The tracking loops are
        contractive — PLL/DLL forget their initial state within a
        re-lock window — so the pass-1 final state of every shard is
        already converged; the handoff repairs exactly the boundary
        transient.  Per-device work is (1 + warmup/t_local) scans:
        near-linear speedup for warmup << t_local.
    """
    sid = jax.lax.axis_index(TIME_AXIS)
    t_local = blocks.shape[0]
    stream0_local = (jnp.asarray(stream_no0).astype(jnp.int32)
                     + sid * t_local)
    perm = [(i, (i + 1) % n_time) for i in range(n_time)]

    init = states0
    final, outs = track_chunk_impl(cfg, init, blocks, stream0_local,
                                   codes, code_ffts)
    if warmup > 0 and n_time > 1:
        w = min(warmup, t_local)
        recv = jax.tree.map(
            lambda x: jax.lax.ppermute(x, TIME_AXIS, perm), final)
        # shard 0's true initial state IS states0; everyone else starts
        # from the left neighbour's converged final state
        init2 = jax.tree.map(
            lambda a, b: jnp.where(sid == 0, a, b), states0, recv)
        final2, outs2 = track_chunk_impl(cfg, init2, blocks[:w],
                                         stream0_local, codes, code_ffts)
        # splice: corrected boundary window + pass-1 steady state
        outs = jax.tree.map(
            lambda a, b: jnp.concatenate([a, b[w:]], axis=0), outs2, outs)
        if w == t_local:
            final = final2
    else:
        for _ in range(max(n_stitch - 1, 0)):
            recv = jax.tree.map(
                lambda x: jax.lax.ppermute(x, TIME_AXIS, perm), final)
            init = jax.tree.map(
                lambda a, b: jnp.where(sid == 0, a, b), states0, recv)
            final, outs = track_chunk_impl(cfg, init, blocks,
                                           stream0_local, codes, code_ffts)
    # add a leading per-shard axis so the caller sees [n_time, C, ...]
    final = jax.tree.map(lambda x: x[None], final)
    return final, outs


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _track_sharded_jit(cfg: ReceiverConfig, mesh: Mesh, n_stitch: int,
                       warmup: int, states, blocks, stream_no0, codes,
                       code_ffts):
    n_time = mesh.shape[TIME_AXIS]
    state_spec = ChannelState(
        *([P(CH_AXIS)] * len(ChannelState._fields)))
    out_spec = ChannelOut(
        *([P(TIME_AXIS, CH_AXIS)] * len(ChannelOut._fields)))
    final_spec = ChannelState(
        *([P(TIME_AXIS, CH_AXIS)] * len(ChannelState._fields)))
    fn = jax.shard_map(
        functools.partial(_track_shard, cfg, n_time, n_stitch, warmup),
        mesh=mesh,
        in_specs=(state_spec, P(TIME_AXIS), P(), P(CH_AXIS), P(CH_AXIS)),
        out_specs=(final_spec, out_spec),
        check_vma=False)
    return fn(states, blocks, stream_no0, codes, code_ffts)


def track_sharded(cfg: ReceiverConfig, mesh: Mesh, states: ChannelState,
                  blocks, stream_no0, codes, code_ffts,
                  n_stitch: int | None = None,
                  warmup_blocks: int | None = None
                  ) -> tuple[ChannelState, ChannelOut]:
    """Track T blocks over the (time, ch) mesh.

    blocks: [T, ngps] complex64, [T, ngps, 2] f32, or grouped planar
    [T, 2, n_cyc, cs] f32, T divisible by the
    time-axis size; states/codes/code_ffts channel axes divisible by the
    ch-axis size (use pad_channels).  Returns (final_states, outs) where
    final_states is the last time-shard's state [C, ...] and outs is
    stacked in stream order [T, C, ...].

    Stitch strategy:
      * warmup_blocks=W (recommended for scaling): ONE boundary-state
        ppermute + a W-block re-scan per shard.  Per-device work is
        (1 + W/t_local) scans -> near-linear speedup; residual error is
        confined to re-lock transients past the warmup window (see
        test_parallel / examples/scaling_sweep.py for measured deltas).
      * n_stitch=k full re-scan passes: k = time-axis size reproduces
        the sequential scan exactly, at the cost of every device
        re-processing the whole stream (no speedup at exactness; the
        default, for correctness-critical use).
    """
    n_time = mesh.shape[TIME_AXIS]
    c_size = mesh.shape[CH_AXIS]
    if warmup_blocks is None:
        warmup_blocks = 0
        if n_stitch is None:
            n_stitch = n_time
    else:
        n_stitch = 1
    t = blocks.shape[0]
    if t % n_time:
        raise ValueError(f"T={t} not divisible by time shards {n_time}")
    c = np.asarray(states.prn).shape[0]
    if c % c_size:
        raise ValueError(f"{c} channels not divisible by ch axis {c_size}"
                         " (use pad_channels)")
    blocks = jax.device_put(
        jnp.asarray(blocks), NamedSharding(mesh, P(TIME_AXIS)))
    sh = NamedSharding(mesh, P(CH_AXIS))
    states = jax.tree.map(lambda x: jax.device_put(x, sh), states)
    codes = jax.device_put(jnp.asarray(codes), sh)
    code_ffts = jax.device_put(jnp.asarray(code_ffts), sh)
    finals, outs = _track_sharded_jit(cfg, mesh, int(n_stitch),
                                      int(warmup_blocks), states,
                                      blocks, stream_no0, codes, code_ffts)
    # outs per shard are stacked on the (sharded) leading axis => already
    # [T, C, ...] in stream order.  finals: take the last shard's row.
    final = jax.tree.map(lambda x: x[-1], finals)
    return final, outs
