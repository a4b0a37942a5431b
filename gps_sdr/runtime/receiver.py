"""Receiver orchestrator: sample stream -> per-second epoch results.

The host shell replacing the reference receiver process
(src/gpsrecv.py:445-548): cold-start acquisition, channel lifecycle,
chunked device tracking, nav-bit assembly, re-acquisition service, and
epoch result emission.  Key architectural translation (SURVEY.md P1-P4):

  reference                              here
  ---------------------------------     --------------------------------
  11 worker processes + mp.Queue RPC     one vmapped/jitted scan over all
  per 32 ms block                        channel slots per ~1 s chunk
  sweep throttled 10 steps/block         one-shot full-grid batched
  across ~5 blocks                       acquisition kernel
  UDP pickle to the evaluator            EpochInput handed to the caller
  b'SWEEP'/b'STOP' command datagrams     request_sweep()/stop() methods

Blocks are batched into chunks of `no_sec` blocks (the reference's own
reporting cadence, gpslib.py:1067-1069) so the device runs a whole
second without host round-trips; stream gaps are applied at chunk
boundaries and detected on-device (erase semantics).
"""

from __future__ import annotations

from dataclasses import dataclass
import functools

import jax
import jax.numpy as jnp
import numpy as np

from gps_sdr.config import ReceiverConfig
from gps_sdr.models.navmsg import NavDecoder
from gps_sdr.ops import cacode
from gps_sdr.ops.acquisition import acquire_all
from gps_sdr.ops.tracking import (ChannelOut, _LAST_IDX,
                                  cn0_from_amp,
                                  init_channel_states,
                                  outs_to_numpy, pack_outs_compact,
                                  reset_channel, summarize_states,
                                  to_f32_pairs,
                                  track_chunk, track_chunk_batched,
                                  track_window, unpack_outs_compact,
                                  unpack_window_compact)
from gps_sdr.runtime.channelmgr import SlotTable, select_sats
from gps_sdr.runtime.evaluator import EpochInput
from gps_sdr.utils.cplist import CodePhaseList


@dataclass
class ReceiverStatus:
    stream_no: int = 0
    sweeps_served: int = 0
    warm_sweeps: int = 0        # cold sweeps served on an almanac-
                                # narrowed grid (warm_start)
    blocks_processed: int = 0
    skipped_blocks: int = 0
    edge_overflows: int = 0     # edges dropped by the compact download
                                # cap (cfg.edge_rate_cap); nonzero means
                                # nav bits may be corrupted that second


class Receiver:
    def __init__(self, cfg: ReceiverConfig, device=None):
        self.cfg = cfg
        self.device = device
        self._codes_tab = cacode.ca_table(cfg)
        self._ffts_tab = cacode.ca_fft_table(cfg)
        n = cfg.max_sat
        self.states = init_channel_states(cfg, n)
        self.slots = SlotTable(n)
        self._codes = np.zeros((n, cfg.code_samples), np.float32)
        self._ffts = np.zeros((n, cfg.code_samples), np.complex64)
        self._codes_dev = jnp.asarray(self._codes)
        self._ffts_dev = jnp.asarray(to_f32_pairs(self._ffts))
        self.decoders = {}                 # slot -> NavDecoder
        self.sweep_all = True              # cold start
        self._stop = False
        self.status = ReceiverStatus()
        self.corr_quality: dict = {}       # prn -> (corr_q, corr_l)
        self.found_sats: list = []
        self.warm_hints: tuple | None = None   # (prns, doppler_bins)

    # -- control surface (replaces UDP command channel, gpsrecv.py:521-536)
    def request_sweep(self) -> None:
        self.sweep_all = True

    def warm_start(self, almanacs: dict, rec_ecef, tow: int) -> bool:
        """Arm the next cold-start sweep with an almanac prediction
        (models/almanac.py): only the predicted-visible PRNs are
        searched, over a Doppler grid shrunk to the predicted span.
        No reference equivalent — it decodes no subframe-4/5 pages and
        always sweeps all 31 PRNs over the full band.  Falls back to
        the full grid automatically if the warm sweep finds too few
        satellites.  Returns True if the hint was armed."""
        from gps_sdr.models.almanac import acquisition_hints

        prns, bins = acquisition_hints(
            almanacs, rec_ecef, tow, step_freq=self.cfg.step_freq,
            max_prns=max(self.cfg.max_sat + 4, 12))
        if prns is None:
            return False
        self.warm_hints = (prns, bins)
        return True

    def stop(self) -> None:
        self._stop = True

    # -- channel lifecycle --
    def _activate(self, prn: int, freq: float, delay: int) -> None:
        slot = self.slots.assign(prn)
        self.states = reset_channel(self.states, slot, prn, freq, delay,
                                    self.cfg)
        self._codes[slot] = self._codes_tab[prn]
        self._ffts[slot] = self._ffts_tab[prn]
        self.decoders[slot] = NavDecoder(ngps=self.cfg.ngps)

    def _deactivate(self, prn: int) -> None:
        slot = self.slots.free(prn)
        self.states = reset_channel(self.states, slot, 0, 0.0, 0, self.cfg,
                                    active=False)
        self._codes[slot] = 0
        self._ffts[slot] = 0
        self.decoders.pop(slot, None)

    def _refresh_code_tables(self) -> None:
        self._codes_dev = jnp.asarray(self._codes)
        self._ffts_dev = jnp.asarray(to_f32_pairs(self._ffts))

    def _serve_sweep_all(self, block: np.ndarray,
                         found: list | None = None) -> None:
        """Cold start / global re-sweep: one-shot full-grid acquisition and
        channel-set update (replaces the staged sweepAllSats + pool
        add/remove, gpsrecv.py:473-490).  An armed almanac warm hint
        (warm_start) shrinks the first sweep's grid; if it under-
        delivers, the full grid runs as the fallback.  `found` skips the
        device acquisition and reuses another receiver's result — the
        serving cold start on SHARED capture replicas ran S identical
        full-grid sweeps (StreamServer passes the first stream's)."""
        hints, self.warm_hints = self.warm_hints, None
        if found is not None:
            self.found_sats = list(found)
        else:
            self.found_sats = []
            if hints is not None:
                self.found_sats = acquire_all(
                    self.cfg, block, self._ffts_tab,
                    prns=hints[0], dopplers=hints[1])
                self.status.warm_sweeps += 1
            if len(self.found_sats) < self.cfg.min_sat:
                self.found_sats = acquire_all(self.cfg, block,
                                              self._ffts_tab)
        del_set, new_set = select_sats(self.slots.active, self.found_sats,
                                       self.corr_quality, self.cfg.max_sat)
        for prn in del_set:
            self._deactivate(prn)
        by_prn = {f[1]: f for f in self.found_sats}
        for prn in new_set:
            _, _, freq, delay = by_prn[prn]
            self._activate(prn, freq, delay)
        self._refresh_code_tables()
        self.sweep_all = False

    def _serve_channel_sweeps(self, block: np.ndarray,
                              request_slots: list[int]) -> list[int]:
        """Re-acquire individual channels whose 60 s correlation quality
        collapsed (the per-channel sweep, gpslib.py:1362-1380, served
        host-side as one batched grid search).  Returns served slots."""
        prns = [self.slots.slot_prn[s] for s in request_slots]
        found = acquire_all(self.cfg, block, self._ffts_tab, prns=prns)
        by_prn = {f[1]: f for f in found}
        summary = {k: np.asarray(v) for k, v in
                   summarize_states(self.cfg, self.states).items()}
        for slot, prn in zip(request_slots, prns):
            old_freq = float(summary["freq"][slot])
            old_delay = int(summary["delay"][slot])
            if prn in by_prn:
                _, _, freq, delay = by_prn[prn]
            else:
                freq, delay = old_freq, old_delay   # restore on failure
            # setPhaseUnlocked + fresh correlation history
            self.states = reset_channel(self.states, slot, prn, freq,
                                        delay, self.cfg)
            self.decoders[slot] = NavDecoder(ngps=self.cfg.ngps)
            self.status.sweeps_served += 1
        return request_slots

    # -- main loop --
    def run(self, block_iter, skip_iter=None):
        """Consume NGPS-sample blocks; yield EpochInput once per chunk.

        block_iter yields complex64[ngps]; skip_iter (optional) yields the
        number of blocks dropped before each block (buffer overflow
        accounting, gpsrecv.py:469-471).
        """
        cfg = self.cfg
        t = cfg.no_sec
        chunk: list[np.ndarray] = []
        skipped_before_chunk = 0
        swept_slots: list[int] = []

        for item in block_iter:
            if self._stop:
                return
            skip = next(skip_iter) if skip_iter is not None else 0
            if skip:
                # force a chunk boundary so the gap lands between chunks
                if chunk:
                    yield self._process_chunk(chunk, swept_slots,
                                              skipped_before_chunk)
                    chunk = []
                skipped_before_chunk = skip
                self.status.stream_no += skip
                self.status.skipped_blocks += skip

            if self.sweep_all:
                self._serve_sweep_all(item)
                self.status.stream_no += 1
                self.status.blocks_processed += 1
                continue

            chunk.append(item)
            if len(chunk) == t:
                epoch, swept_slots = self._run_chunk(
                    chunk, skipped_before_chunk)
                skipped_before_chunk = 0
                chunk = []
                yield epoch
        if chunk:
            epoch, _ = self._run_chunk(chunk, skipped_before_chunk)
            yield epoch

    def _run_chunk(self, chunk: list[np.ndarray], skipped: int):
        outs_dev, stream0 = self._dispatch_chunk(chunk)
        return self._consume_chunk(chunk, outs_dev, stream0, skipped)

    def _dispatch_chunk(self, chunk):
        """Enqueue tracking for one chunk; returns the (device) outs
        handle without blocking — downloads happen in _consume_chunk so
        run_device can overlap the next chunk's device work with the
        current chunk's download + host-side evaluation."""
        cfg = self.cfg
        stream0 = self.status.stream_no + 1
        if isinstance(chunk, _DeviceChunk):
            stacked = chunk.blocks_dev          # already on device
        elif isinstance(chunk[0], np.ndarray):
            stacked = jnp.asarray(to_f32_pairs(np.stack(chunk)))
        else:
            stacked = jnp.stack(chunk)
        # the batched path handles non-divisible tails itself (fused
        # steps over the divisible prefix + a sequential tail scan)
        track = (track_chunk_batched if cfg.blocks_per_step > 1
                 else track_chunk)
        self.states, outs = track(cfg, self.states, stacked,
                                  jnp.float32(stream0),
                                  self._codes_dev, self._ffts_dev)
        nb = len(chunk)
        self.status.stream_no += nb
        self.status.blocks_processed += nb
        return outs, stream0

    def _consume_chunk(self, chunk, outs_dev, stream0: int, skipped: int,
                       poll: bool = True, window: bool = False):
        """Consume one chunk's (or, with window=True, one concatenated
        download window's) tracking outputs into an EpochInput.

        window=True widens the per-chunk "last block" gates to the
        whole window so nothing is missed that per-chunk consumption
        would have caught: subframes poll if the channel was locked at
        ANY block (not just the final one — a lock flicker at the
        window boundary must not defer a whole window of subframes),
        and sweep requests are honored if raised at ANY block (the
        device recomputes the 60 s corr-quality gate per block; the
        reference latches SWEEP until served, gpslib.py:1134-1138)."""
        cfg = self.cfg
        outs: ChannelOut = (outs_dev
                            if isinstance(outs_dev.code_phase, np.ndarray)
                            else outs_to_numpy(outs_dev))

        # code phases + nav bits per slot (vectorized host ingest)
        coph: dict = {}
        cfrq: dict = {}
        for slot, prn in enumerate(self.slots.slot_prn):
            if prn == 0:
                continue
            self.decoders[slot].push_chunk(
                outs.sign0[:, slot], outs.edge_ms[:, slot],
                outs.edge_local[:, slot], outs.edge_valid[:, slot],
                stream_no0=stream0, erased=outs.erased[:, slot])
            cp = outs.code_phase[:, slot]
            ok = np.nonzero(cp >= 0)[0]
            if ok.size:
                snos = stream0 + ok
                coph[prn] = CodePhaseList(snos, cp[ok])
                if cfg.carrier_smoothing > 0:
                    fq = outs.freq[:, slot]
                    cfrq[prn] = CodePhaseList(snos, fq[ok])
            self.corr_quality[prn] = (float(outs.corr_q[-1, slot]),
                                      float(outs.corr_l[-1, slot]))

        # subframes + report values (reportValues, gpslib.py:1124-1131)
        frames: list = []
        for slot, prn in enumerate(self.slots.slot_prn):
            if prn == 0:
                continue
            was_locked = (bool(outs.locked[:, slot].any()) if window
                          else bool(outs.locked[-1, slot]))
            subs = (self.decoders[slot].poll_subframes()
                    if poll and was_locked else [])
            if not subs:
                subs = [{}]
            for sf in subs:
                sf["SAT"] = prn
                sf["AMP"] = float(outs.amplitude[-1, slot])
                sf["CN0"] = float(cn0_from_amp(outs.amplitude[-1, slot]))
                sf["CRM"] = float(outs.norm_max[-1, slot])
                sf["FRQ"] = float(outs.freq[-1, slot])
                sf["SWP"] = False
            frames += subs

        # service per-channel sweep requests on the chunk's last block
        # (window mode: any block's request counts — see docstring)
        req_flags = (outs.sweep_request.any(axis=0) if window
                     else outs.sweep_request[-1])
        req = [s for s in range(cfg.max_sat)
               if req_flags[s] and self.slots.slot_prn[s] != 0]
        swept = []
        if req:
            swept = self._serve_channel_sweeps(np.asarray(chunk[-1]), req)
            for sf in frames:
                if self.slots.slot_prn and sf.get("SAT") in \
                        [self.slots.slot_prn[s] for s in swept]:
                    sf["SWP"] = True

        epoch = EpochInput(skipped_samples=skipped * cfg.ngps,
                           frames=frames, code_phases=coph,
                           carrier_freqs=cfrq or None)
        return epoch, swept

    def _consume_window_compact(self, chunk, cw, stream0: int, t: int,
                                poll: bool = True):
        """Window-mode consume straight from a CompactWindow (sparse
        transport view, ops/tracking.py unpack_window_compact): the
        dense-plane scatter + per-chunk concat of the unpack path is
        skipped entirely.  Epoch-for-epoch identical to
        _consume_chunk(concat_outs(...), window=True) — pinned by the
        epoch_per_window equivalence tests.  `chunk` is the last
        chunk's block handle (sweep service)."""
        cfg = self.cfg
        sl = self._edge_sl
        w = cw.last.shape[0]
        li = _LAST_IDX

        coph: dict = {}
        cfrq: dict = {}
        for slot, prn in enumerate(self.slots.slot_prn):
            if prn == 0:
                continue
            aux = cw.aux[:, slot]
            dec = self.decoders[slot]
            pos = cw.edge_pos[:, slot]                     # [w, cap]
            valid = pos >= 0
            if (aux >= 4).any():
                # rare (slot reset mid-window): rebuild this channel's
                # dense planes and take the exact per-block erase path
                T = w * t
                ms_d = np.zeros((T, sl), np.int32)
                loc_d = np.zeros((T, sl), np.int32)
                val_d = np.zeros((T, sl), bool)
                wk, ek = np.nonzero(valid)
                if wk.size:
                    fp = pos[wk, ek]
                    tb = wk * t + fp // sl
                    es = fp % sl
                    ms_d[tb, es] = cw.edge_ms[:, slot][wk, ek]
                    loc_d[tb, es] = cw.edge_local[:, slot][wk, ek]
                    val_d[tb, es] = True
                dec.push_chunk((aux % 4 - 1).astype(np.int8), ms_d,
                               loc_d, val_d, stream_no0=stream0,
                               erased=aux >= 4)
            else:
                if dec.last_sign == 0:
                    nz = np.nonzero(aux != 1)[0]
                    if nz.size:
                        dec.last_sign = int(aux[nz[0]]) - 1
                wk, ek = np.nonzero(valid)
                if wk.size:
                    fp = pos[wk, ek]
                    blk = np.int64(stream0) + wk * t + fp // sl
                    st = blk * cfg.ngps \
                        + cw.edge_local[:, slot][wk, ek]
                    ms = (st // dec.ms_from_st if dec.ms_from_st
                          else cw.edge_ms[:, slot][wk, ek])
                    dec.edge_parts.append((ms.astype(np.int64), st))
            cp = cw.code_phase[:, slot]
            ok = np.nonzero(cp >= 0)[0]
            if ok.size:
                snos = stream0 + ok
                coph[prn] = CodePhaseList(snos, cp[ok])
                if cfg.carrier_smoothing > 0:
                    cfrq[prn] = CodePhaseList(snos,
                                              cw.freq[:, slot][ok])
            self.corr_quality[prn] = (
                float(cw.last[-1, slot, li["corr_q"]]),
                float(cw.last[-1, slot, li["corr_l"]]))

        frames: list = []
        for slot, prn in enumerate(self.slots.slot_prn):
            if prn == 0:
                continue
            was_locked = bool(
                (cw.last[:, slot, li["locked"]] > 0.5).any())
            subs = (self.decoders[slot].poll_subframes()
                    if poll and was_locked else [])
            if not subs:
                subs = [{}]
            amp = float(cw.last[-1, slot, li["amplitude"]])
            for sf in subs:
                sf["SAT"] = prn
                sf["AMP"] = amp
                sf["CN0"] = float(cn0_from_amp(amp))
                sf["CRM"] = float(cw.last[-1, slot, li["norm_max"]])
                sf["FRQ"] = float(cw.last[-1, slot, li["freq"]])
                sf["SWP"] = False
            frames += subs

        req_flags = (cw.last[:, :, li["sweep_request"]] > 0.5).any(axis=0)
        req = [s for s in range(cfg.max_sat)
               if req_flags[s] and self.slots.slot_prn[s] != 0]
        swept = []
        if req:
            swept = self._serve_channel_sweeps(np.asarray(chunk[-1]), req)
            for sf in frames:
                if self.slots.slot_prn and sf.get("SAT") in \
                        [self.slots.slot_prn[s] for s in swept]:
                    sf["SWP"] = True

        epoch = EpochInput(skipped_samples=0, frames=frames,
                           code_phases=coph,
                           carrier_freqs=cfrq or None)
        return epoch, swept

    def _process_chunk(self, chunk, swept_slots, skipped):
        epoch, _ = self._run_chunk(chunk, skipped)
        return epoch

    def run_device(self, chunk_provider, n_chunks: int,
                   chunk_blocks: int | None = None):
        """Device-resident streaming: IQ never crosses the host.

        chunk_provider(first_block, n_blocks) -> device array
        [n_blocks, ngps] complex64 (e.g. DeviceScenarioSynth.chunk or
        JaxSynth.chunk; in production a DMA'd capture buffer).  Only
        the per-chunk ChannelOut summaries are downloaded.  Yields
        EpochInput once per chunk, exactly like run().

        The loop pipelines cfg.chunks_per_download chunks: each chunk's
        tracking is dispatched (async) and its ChannelOut reduced
        on-device to the compact transport buffer (pack_outs_compact —
        sparse edges + per-block code phases + last-block summaries);
        one batched transfer then downloads the whole window.  The
        fixed per-transfer cost is paid once per window and the payload
        shrinks ~10x vs the dense planes.  Channel sweeps
        consequently take effect up to chunks_per_download chunks later
        than in run() (the reference's own sweep spans ~5 blocks,
        gpsglob.py:41-44).
        """
        cfg = self.cfg
        t = chunk_blocks or cfg.no_sec
        cap = self._edge_cap(t)
        w = max(1, cfg.chunks_per_download)
        # windows in flight: at >= 2 the host's consume of window k
        # overlaps both the device computing window k+1 AND the
        # device->host transfer of window k+1 (started async the moment
        # its stack is formed)
        inflight = max(1, cfg.download_windows_in_flight)
        held = []                       # [(chunk, packed_dev, stream0)]
        windows = []                    # [(items, stacked_dev)]

        def flush_held():
            # every batched transfer stacks EXACTLY w buffers (partial
            # windows pad by repeating the last buffer and unpack only
            # the valid prefix) so _stack_bufs compiles once, during
            # warmup: a leftover-count stack would recompile (~0.4 s)
            # inside the steady-state loop, which alone cost the full
            # receiver ~2x realtime factor
            if not held:
                return
            bufs = [p[1] for p in held]
            if w > 1:
                bufs = bufs + [bufs[-1]] * (w - len(bufs))
                stacked = _stack_bufs(*bufs)
            else:
                stacked = bufs[0][None]
            stacked.copy_to_host_async()
            windows.append((held[:], stacked))
            held.clear()

        def drain(count=None):
            n = len(windows) if count is None else count
            while n > 0 and windows:
                take, stacked = windows.pop(0)
                host = np.asarray(stacked)  # ONE transfer per window
                if cfg.epoch_per_window:
                    # one consume pass over the whole window, straight
                    # from the sparse transport view (== per-chunk
                    # consumes merged, see _consume_window_compact)
                    cw = unpack_window_compact(
                        host[:len(take)], len(take[0][0]), cfg.max_sat,
                        self._edge_sl, cap, cfg.carrier_smoothing > 0)
                    self.status.edge_overflows += int(cw.dropped.sum())
                    yield self._consume_window_compact(
                        take[-1][0], cw, take[0][2],
                        len(take[0][0]))[0]
                    n -= 1
                    continue
                for i, ((chunk, _, stream0), row) in enumerate(
                        zip(take, host)):
                    outs, dropped = unpack_outs_compact(
                        row, len(chunk), cfg.max_sat,
                        self._edge_sl, cap, cfg.carrier_smoothing > 0)
                    self.status.edge_overflows += int(dropped.sum())
                    poll = (not cfg.defer_subframe_poll
                            or i == len(take) - 1)
                    yield self._consume_chunk(chunk, outs, stream0, 0,
                                              poll=poll)[0]
                n -= 1

        # stream numbering continues from wherever this receiver left
        # off (base = 0 for a fresh receiver; a checkpoint-resumed
        # receiver keeps counting, or its decoders/pseudorange engines
        # would see stream numbers jump backward and silently discard
        # every subsequent code phase — the provider's `first` stays
        # relative to THIS call)
        base = self.status.stream_no
        # fused window dispatch: one device program tracks + packs a
        # whole w-chunk window (track_window) — one dispatch per window
        # instead of several per chunk (see StreamServer.run)
        fused = cfg.fused_window_dispatch and w > 1
        ci = 0
        while ci < n_chunks:
            if self._stop:
                break
            first = ci * t
            if fused and ci + w <= n_chunks and not self.sweep_all:
                flush_held()          # partial window from a cold start
                win = _window_chunks(chunk_provider(first, w * t), w)
                self.status.stream_no = base + first
                stream0 = self.status.stream_no + 1
                self.states, packed = track_window(
                    cfg, self.states, win, jnp.float32(stream0),
                    self._codes_dev, self._ffts_dev, cap,
                    cfg.carrier_smoothing > 0)
                self.status.stream_no += w * t
                self.status.blocks_processed += w * t
                packed.copy_to_host_async()
                windows.append((
                    [(_WindowChunk(win, i), None, stream0 + i * t)
                     for i in range(w)], packed))
                ci += w
                if len(windows) >= inflight:
                    yield from drain(1)
                continue
            blocks_dev = chunk_provider(first, t)
            if self.sweep_all:
                # channel set changes states: drain the pipeline first.
                # acquisition needs one block on the host (as f32
                # planes, the transfer boundary's only dtype)
                flush_held()
                yield from drain()
                blk0 = _download_block(blocks_dev, 0)
                self._serve_sweep_all(blk0)
            chunk = _DeviceChunk(blocks_dev)
            self.status.stream_no = base + first
            outs_dev, stream0 = self._dispatch_chunk(chunk)
            held.append((chunk,
                         pack_outs_compact(outs_dev, cap,
                                           cfg.carrier_smoothing > 0),
                         stream0))
            ci += 1
            if len(held) == w:
                flush_held()
            if len(windows) >= inflight:
                yield from drain(1)
        flush_held()
        yield from drain()

    def _edge_cap(self, chunk_blocks: int) -> int:
        """Compact-download edge capacity for a chunk of this length."""
        cfg = self.cfg
        return max(16, int(np.ceil(
            chunk_blocks * cfg.block_sec * cfg.edge_rate_cap)))

    @property
    def _edge_sl(self) -> int:
        return self.cfg.n_cyc + 1


class _DeviceChunk:
    """Adapter: lets _run_chunk treat a device array as the chunk."""

    def __init__(self, blocks_dev):
        self.blocks_dev = blocks_dev

    def __len__(self):
        return self.blocks_dev.shape[0]

    def __getitem__(self, i):
        if i == 0 or i == -1:   # sweep service uses single blocks
            return _download_block(self.blocks_dev, i)
        raise IndexError(i)


@functools.partial(jax.jit, static_argnums=1)
def _window_chunks(blocks, w: int):
    """[w*t, *iq] -> [w, t, *iq]: the fused-window dispatch input."""
    return blocks.reshape((w, blocks.shape[0] // w) + blocks.shape[1:])


@jax.jit
def _index_window(win_dev, ci):
    return jax.lax.dynamic_index_in_dim(win_dev, ci, keepdims=False)


@jax.jit
def _index_window_stream(win_dev, ci, si):
    chunk = jax.lax.dynamic_index_in_dim(win_dev, ci, keepdims=False)
    return jax.lax.dynamic_index_in_dim(chunk, si, keepdims=False)


class _WindowChunk:
    """_DeviceChunk-compatible lazy view of chunk ci inside a fused
    window buffer [w, t, *iq] (or [w, S, t, *iq] with a stream index,
    independent-front-end serving): nothing touches the device unless
    a channel sweep actually services this chunk (then one jitted
    slice feeds the usual single-block download)."""

    def __init__(self, win_dev, ci: int, si: int | None = None):
        self.win_dev = win_dev
        self.ci = ci
        self.si = si

    def __len__(self):
        return self.win_dev.shape[1 if self.si is None else 2]

    def __getitem__(self, i):
        if i == 0 or i == -1:
            if self.si is None:
                chunk = _index_window(self.win_dev, jnp.int32(self.ci))
            else:
                chunk = _index_window_stream(
                    self.win_dev, jnp.int32(self.ci), jnp.int32(self.si))
            return _download_block(chunk, i)
        raise IndexError(i)


def concat_outs(outs_list: list) -> ChannelOut:
    """Concatenate per-chunk ChannelOuts along the block axis — the
    window-merge contract shared by Receiver.run_device and
    StreamServer.run: consume with the window's FIRST stream0 and the
    LAST chunk's blocks (sweep service reads the final block), and pass
    window=True so last-block gates widen to the whole window."""
    if len(outs_list) == 1:
        return outs_list[0]
    return jax.tree.map(lambda *xs: np.concatenate(xs, axis=0),
                        *outs_list)


@jax.jit
def _stack_bufs(*bufs):
    """Stack N compact transport buffers for one batched download."""
    return jnp.stack(bufs)


@functools.partial(jax.jit, static_argnums=1)
def _block_f32(blocks_dev, i: int):
    """One block as f32 re/im planes [2, ngps] (one jitted program
    instead of several eager dispatches)."""
    blk = blocks_dev[i]
    if blk.ndim == 3:                      # grouped planar [2, n_cyc, cs]
        return blk.reshape(2, -1).astype(jnp.float32)
    if blk.ndim == 2:                      # planar [2, ngps]
        return blk.astype(jnp.float32)
    return jnp.stack([jnp.real(blk), jnp.imag(blk)]).astype(jnp.float32)


def _download_block(blocks_dev, i):
    """One block to the host as complex64 via an f32-planes transfer.
    Accepts c64[T, ngps], planar f32[T, 2, ngps], or grouped planar
    f32[T, 2, n_cyc, cs] device chunks."""
    plane = np.asarray(_block_f32(blocks_dev, i))
    return plane[0] + 1j * plane[1]
