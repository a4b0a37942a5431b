"""Multi-receiver serving: S independent streams on one chip.

Production deployment shape: one accelerator serves many concurrent
RTL-SDR front ends (fleets of receivers, wide-area monitoring).  The
reference binds one multicore CPU to ONE receiver (README.md:23-24);
here the stream axis is a vmapped batch dimension of the tracking scan
(ops/tracking.py track_streams), so S receivers cost one device program
per chunk plus one batched compact download, while the host keeps one
slot table / nav decoder / epoch pipeline per stream.

The device loop mirrors Receiver.run_device (pipelined dispatch,
windowed downloads); host-side channel management (cold-start
acquisition, per-channel re-sweeps) runs per stream and scatters its
slot updates back into the stacked state.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from gps_sdr.config import ReceiverConfig
from gps_sdr.ops.tracking import (_LAST_IDX, pack_outs_compact,
                                  track_streams,
                                  track_streams_window,
                                  unpack_outs_compact,
                                  unpack_window_compact)
from gps_sdr.runtime.receiver import (Receiver, _DeviceChunk,
                                      _WindowChunk, _window_chunks,
                                      _download_block)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _pack_streams(outs, cap: int, with_freq: bool = False):
    """vmap pack_outs_compact over the stream axis -> [S, L] f32."""
    return jax.vmap(lambda o: pack_outs_compact(o, cap, with_freq))(outs)


@jax.jit
def _stack_windows(*bufs):
    return jnp.stack(bufs)                      # [N, S, L]


@functools.partial(jax.jit, static_argnums=0)
def _stack_stream_windows(w: int, *bufs):
    """S per-stream window fetches [w*t, *iq] -> [w, S, t, *iq] (the
    shared=False track_streams_window layout)."""
    x = jnp.stack(bufs)                         # [S, w*t, *iq]
    x = x.reshape((x.shape[0], w, x.shape[1] // w) + x.shape[2:])
    return jnp.moveaxis(x, 0, 1)


@jax.jit
def _slice_stream(tree, s):
    """One stream's state slice as ONE jitted program (eagerly indexing
    every leaf, `x[s]`, dispatches ~20 tiny device ops)."""
    return jax.tree.map(
        lambda x: jax.lax.dynamic_index_in_dim(x, s, keepdims=False),
        tree)


class StreamServer:
    """Serve S independent receivers from one device.

    Each stream keeps its own Receiver (slot table, decoders, status)
    and — by the caller — its own Evaluator; tracking for all streams
    runs as ONE device call per chunk (track_streams) and all packed
    outputs cross the link as ONE windowed transfer.
    """

    def __init__(self, cfg: ReceiverConfig, n_streams: int, mesh=None):
        """mesh: optional one-axis jax.sharding.Mesh
        (parallel.mesh.make_stream_mesh) to shard the stream axis over
        devices — serving scale-out; n_streams must divide by its size."""
        self.cfg = cfg
        self.receivers = [Receiver(cfg) for _ in range(n_streams)]
        self._stacked = None        # ChannelState with leading [S]
        self._codes_dev = None      # [S, C, cs]
        self._ffts_dev = None
        self._sharding = None
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec
            from gps_sdr.parallel.mesh import STREAM_AXIS
            if n_streams % mesh.shape[STREAM_AXIS]:
                raise ValueError(
                    f"{n_streams} streams not divisible over "
                    f"{mesh.shape[STREAM_AXIS]} devices")
            self._sharding = NamedSharding(mesh,
                                           PartitionSpec(STREAM_AXIS))

    @property
    def n_streams(self) -> int:
        return len(self.receivers)

    def _restack(self) -> None:
        self._stacked = jax.tree.map(
            lambda *x: self._put(jnp.stack(x)),
            *[r.states for r in self.receivers])
        self._codes_dev = self._put(jnp.stack(
            [r._codes_dev for r in self.receivers]))
        self._ffts_dev = self._put(jnp.stack(
            [r._ffts_dev for r in self.receivers]))

    def _put(self, x):
        """Lay a stream-major array out over the stream mesh (no-op in
        single-device serving)."""
        return x if self._sharding is None else jax.device_put(
            x, self._sharding)

    def _scatter_stream(self, s: int) -> None:
        """Push receiver s's (host-managed) state back into the stack."""
        self._stacked = jax.tree.map(
            lambda big, x: self._put(big.at[s].set(x)), self._stacked,
            self.receivers[s].states)
        self._codes_dev = self._put(self._codes_dev.at[s].set(
            self.receivers[s]._codes_dev))
        self._ffts_dev = self._put(self._ffts_dev.at[s].set(
            self.receivers[s]._ffts_dev))

    def run(self, providers, n_chunks: int,
            chunk_blocks: int | None = None):
        """Yield (stream_idx, EpochInput) pairs, chunk-major.

        providers: one callable(first_block, n_blocks) -> device chunk
        shared by every stream (serving replicas of one capture), or a
        list of S callables (independent front ends).

        Wall-clock stage totals accumulate in `self.perf` (seconds):
        dispatch (provider + track_streams launch), pack, stack+async
        copy, transfer (blocking np.asarray of a window), unpack (host
        decode of packed buffers), consume (receiver nav/epoch build).
        Evaluator time is the caller's — everything outside the
        generator.  Cheap (a few perf_counter pairs per chunk); used by
        bench to locate the serving knee.
        """
        import time as _time
        perf = self.perf = {k: 0.0 for k in (
            "dispatch", "pack", "stack", "transfer", "unpack",
            "consume")}
        _pc = _time.perf_counter
        cfg = self.cfg
        s_n = self.n_streams
        if callable(providers):
            providers = [providers] * s_n
        shared = all(p is providers[0] for p in providers)
        t = chunk_blocks or cfg.no_sec
        cap = self.receivers[0]._edge_cap(t)
        sl = cfg.n_cyc + 1
        w = max(1, cfg.chunks_per_download)
        inflight = max(1, cfg.download_windows_in_flight)
        held = []                 # [(chunks, packed_dev, stream0)]
        windows = []              # [(items, stacked_dev)]

        def flush_held():
            # fixed-size stacks only (pad partial windows, unpack the
            # valid prefix): a leftover-count _stack_windows would
            # recompile (~0.4 s) inside the steady-state serving loop.
            # The host copy starts async so the transfer overlaps the
            # consume of the previous window.
            if not held:
                return
            t0 = _pc()
            bufs = [p[1] for p in held]
            if w > 1:
                bufs = bufs + [bufs[-1]] * (w - len(bufs))
                stacked = _stack_windows(*bufs)
            else:
                stacked = bufs[0][None]
            stacked.copy_to_host_async()
            windows.append((held[:], stacked))
            held.clear()
            perf["stack"] += _pc() - t0

        def consume_one(s, chunks, outs, stream0, poll, window=False):
            rec = self.receivers[s]
            # expose this stream's device state to the host-side
            # channel manager ONLY when a re-sweep will actually fire
            # (it resets slots on it): slicing every state leaf for
            # every stream every chunk costs S x n_leaves tiny device
            # dispatches per chunk of pure overhead
            want_sweep = (outs.sweep_request.any() if window
                          else outs.sweep_request[-1].any())
            if bool(want_sweep):
                rec.states = _slice_stream(self._stacked, jnp.int32(s))
            c = chunks[s if not shared else 0]
            chunk = c if isinstance(c, _WindowChunk) else _DeviceChunk(c)
            epoch, swept = rec._consume_chunk(chunk, outs, stream0, 0,
                                              poll=poll, window=window)
            if swept:
                self._scatter_stream(s)
            return epoch

        def consume_window(s, chunks, cw, stream0):
            # window-mode consume_one over the sparse transport view
            rec = self.receivers[s]
            want_sweep = (cw.last[:, :, _LAST_IDX["sweep_request"]]
                          > 0.5).any()
            if bool(want_sweep):
                rec.states = _slice_stream(self._stacked, jnp.int32(s))
            c = chunks[s if not shared else 0]
            chunk = c if isinstance(c, _WindowChunk) else _DeviceChunk(c)
            epoch, swept = rec._consume_window_compact(chunk, cw,
                                                       stream0, t)
            if swept:
                self._scatter_stream(s)
            return epoch

        def drain(count=None):
            n = len(windows) if count is None else count
            while n > 0 and windows:
                take, stacked = windows.pop(0)
                t0 = _pc()
                host = np.asarray(stacked)     # ONE transfer per window
                t1 = _pc()
                perf["transfer"] += t1 - t0
                if cfg.epoch_per_window:
                    # one consume pass per stream over the whole window
                    # straight from the sparse transport view (== the
                    # per-chunk epochs merged with defer_subframe_poll;
                    # see Receiver._consume_window_compact)
                    hw = host[:len(take)]             # [w', S, L]
                    for s, rec in enumerate(self.receivers):
                        t2 = _pc()
                        cw = unpack_window_compact(
                            hw[:, s], t, cfg.max_sat, sl, cap,
                            cfg.carrier_smoothing > 0)
                        rec.status.edge_overflows += int(
                            cw.dropped.sum())
                        t3 = _pc()
                        perf["unpack"] += t3 - t2
                        # time consume BEFORE yielding: the generator
                        # suspends at yield, so bracketing the yield
                        # would bill the caller's work (evaluate) to
                        # the consume stage.
                        out = consume_window(s, take[-1][0], cw,
                                             take[0][2])
                        perf["consume"] += _pc() - t3
                        yield s, out
                    n -= 1
                    continue
                for i, ((chunks, _, stream0), win) in enumerate(
                        zip(take, host)):
                    poll = (not cfg.defer_subframe_poll
                            or i == len(take) - 1)
                    for s, rec in enumerate(self.receivers):
                        outs, dropped = unpack_outs_compact(
                            win[s], t, cfg.max_sat, sl, cap,
                            cfg.carrier_smoothing > 0)
                        rec.status.edge_overflows += int(dropped.sum())
                        t2 = _pc()
                        perf["unpack"] += t2 - t1
                        out = consume_one(s, chunks, outs, stream0,
                                          poll)
                        t1 = _pc()
                        perf["consume"] += t1 - t2
                        yield s, out
                n -= 1

        # fused window dispatch: track + pack a whole w-chunk window as
        # ONE device program (ops/tracking.py track_streams_window):
        # one dispatch per window instead of several per chunk.  Shared
        # providers broadcast one window; independent front ends stack
        # S windows [w, S, t, *iq] (note: each in-flight window then
        # retains S chunks of IQ on device until drained — size
        # download_windows_in_flight accordingly).
        fused = (cfg.fused_window_dispatch and w > 1)
        if self._stacked is None and not any(r.sweep_all
                                             for r in self.receivers):
            # resumed from a checkpoint (runtime/checkpoint.py
            # load_server): receivers carry live states but the stacked
            # device copy is gone — re-upload before dispatching
            self._restack()
        ci = 0
        while ci < n_chunks:
            t0 = _pc()
            first = ci * t
            if any(r.sweep_all for r in self.receivers):
                flush_held()
                yield from drain()
                acq_chunks = ([providers[0](first, t)] if shared
                              else [p(first, t) for p in providers])
                # shared capture replicas see identical blocks, so the
                # full-grid acquisition result is identical too: run the
                # device sweep ONCE and hand the result to the other
                # streams (a cold start at S=32 ran 32 identical grids
                # — ~10 s of serial device sweeps).  Warm-hinted
                # receivers sweep their own narrowed grid.
                shared_found = None
                for s, rec in enumerate(self.receivers):
                    if not rec.sweep_all:
                        continue
                    blk0 = _download_block(
                        acq_chunks[s if not shared else 0], 0)
                    if self._stacked is not None:
                        rec.states = _slice_stream(self._stacked,
                                                   jnp.int32(s))
                    had_hints = rec.warm_hints is not None
                    if (shared and not had_hints
                            and shared_found is not None):
                        rec._serve_sweep_all(blk0, found=shared_found)
                    else:
                        rec._serve_sweep_all(blk0)
                        if shared and not had_hints:
                            shared_found = rec.found_sats
                    if self._stacked is not None:
                        self._scatter_stream(s)
                if self._stacked is None:      # cold start: first stack
                    self._restack()
            stream0 = self.receivers[0].status.stream_no + 1
            if fused and ci + w <= n_chunks:
                flush_held()          # partial window from a cold start
                if shared:
                    win = _window_chunks(providers[0](first, w * t), w)

                    def mk(i):
                        return [_WindowChunk(win, i)]
                else:
                    win = _stack_stream_windows(
                        w, *[p(first, w * t) for p in providers])

                    def mk(i):
                        return [_WindowChunk(win, i, s)
                                for s in range(s_n)]
                # (no _put: the window's stream axis is interior —
                # GSPMD propagates the layout from the stacked states)
                self._stacked, packed = track_streams_window(
                    cfg, self._stacked, win, jnp.float32(stream0),
                    self._codes_dev, self._ffts_dev, cap,
                    cfg.carrier_smoothing > 0, shared)
                for rec in self.receivers:
                    rec.status.stream_no += w * t
                    rec.status.blocks_processed += w * t
                t1 = _pc()
                perf["dispatch"] += t1 - t0
                packed.copy_to_host_async()
                windows.append((
                    [(mk(i), None, stream0 + i * t)
                     for i in range(w)], packed))
                perf["stack"] += _pc() - t1
                ci += w
                if len(windows) >= inflight:
                    yield from drain(1)
                continue
            chunks = ([providers[0](first, t)] if shared
                      else [p(first, t) for p in providers])
            blocks = self._put(jnp.broadcast_to(
                chunks[0][None], (s_n,) + chunks[0].shape)
                if shared else jnp.stack(chunks))
            self._stacked, outs = track_streams(
                cfg, self._stacked, blocks, jnp.float32(stream0),
                self._codes_dev, self._ffts_dev)
            for rec in self.receivers:
                rec.status.stream_no += t
                rec.status.blocks_processed += t
            t1 = _pc()
            perf["dispatch"] += t1 - t0
            held.append((chunks,
                         _pack_streams(outs, cap,
                                       cfg.carrier_smoothing > 0),
                         stream0))
            perf["pack"] += _pc() - t1
            ci += 1
            if len(held) == w:
                flush_held()
            if len(windows) >= inflight:
                yield from drain(1)
        flush_held()
        yield from drain()
        # hand the final device states back to the receivers
        for s, rec in enumerate(self.receivers):
            rec.states = _slice_stream(self._stacked, jnp.int32(s))
