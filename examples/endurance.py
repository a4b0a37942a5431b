"""Endurance stress: hours-class synthetic streams through the tracker.

BASELINE.md stress configuration "hours-long synthetic streams": the IQ
is generated on-device (models/sim_jax.py) and fed chunk-by-chunk into
the fused tracking scan without ever crossing the host boundary, so the
only wall-clock cost is device time + one download per chunk.
Verifies that tracking state (f32 phase accumulators, quality rings,
delay wrap-around as the code phase drifts through whole code periods)
stays healthy over long streams.

Usage:
    python examples/endurance.py [--minutes 10] [--channels 12]
                                 [--chunk-blocks 512] [--k 8]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=10.0)
    ap.add_argument("--channels", type=int, default=12)
    ap.add_argument("--chunk-blocks", type=int, default=512)
    ap.add_argument("--k", type=int, default=8)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from gps_sdr.config import ReceiverConfig
    from gps_sdr.models.simulator import SatSignal, random_bits
    from gps_sdr.models.sim_jax import JaxSynth
    from gps_sdr.ops import cacode
    from gps_sdr.ops.tracking import (init_channel_states,
                                      reset_channel,
                                      summarize_states, to_f32_pairs,
                                      track_chunk_batched)

    cfg = ReceiverConfig(max_sat=args.channels, blocks_per_step=args.k)
    n_blocks = int(args.minutes * 60 / cfg.block_sec)
    n_chunks = max(1, n_blocks // args.chunk_blocks)
    n_bits = int(args.minutes * 60 * 50) + 4096

    rng = np.random.default_rng(7)
    prns = rng.choice(np.arange(2, 33), args.channels, replace=False)
    sats = [SatSignal(prn=int(p), doppler=float(rng.uniform(-4500, 4500)),
                      code_delay=float(rng.uniform(0, cfg.code_samples)),
                      amplitude=float(rng.uniform(0.8, 1.2)),
                      nav_bits=random_bits(n_bits, seed=i))
            for i, p in enumerate(prns)]
    synth = JaxSynth(cfg, sats, noise_std=0.7, seed=3)

    tab, ftab = cacode.ca_table(cfg), cacode.ca_fft_table(cfg)
    codes = jnp.asarray(np.stack([tab[s.prn] for s in sats]))
    ffts = jnp.asarray(to_f32_pairs(np.stack([ftab[s.prn] for s in sats])))
    states = init_channel_states(cfg, args.channels)
    for i, s in enumerate(sats):
        states = reset_channel(states, i, s.prn, s.doppler,
                               int(s.code_delay) % cfg.code_samples, cfg)

    print(f"endurance: {args.minutes:.0f} min = {n_blocks} blocks, "
          f"{args.channels} channels, chunk {args.chunk_blocks}, "
          f"backend {jax.default_backend()}")
    t0 = time.time()
    worst_found = 1.0
    for ci in range(n_chunks):
        first = ci * args.chunk_blocks
        blk = synth.chunk(first, args.chunk_blocks)
        states, outs = track_chunk_batched(
            cfg, states, blk, jnp.float32(first + 1), codes, ffts)
        found = float(np.asarray(jnp.mean(
            (outs.code_phase >= 0).astype(jnp.float32))))
        locked = int(np.asarray(jnp.sum(
            outs.locked[-1].astype(jnp.float32))))
        worst_found = min(worst_found, found) if ci > 0 else worst_found
        if ci % max(1, n_chunks // 10) == 0 or ci == n_chunks - 1:
            mins = (first + args.chunk_blocks) * cfg.block_sec / 60
            print(f"  t={mins:6.1f} min  found={found:.4f} "
                  f"locked={locked}/{args.channels} "
                  f"(wall {time.time()-t0:.0f} s)", flush=True)

    summary = {k: np.asarray(v)
               for k, v in summarize_states(cfg, states).items()}
    freq_err = np.abs(summary["freq"]
                      - np.array([s.doppler for s in sats]))
    sig_sec = n_chunks * args.chunk_blocks * cfg.block_sec
    wall = time.time() - t0
    print(f"\n{sig_sec:.0f} s of signal in {wall:.1f} s wall "
          f"({sig_sec / wall:.0f}x realtime incl. per-chunk latency)")
    print(f"final locked: {int((summary['locked'] > 0.5).sum())}"
          f"/{args.channels}   max freq err: {freq_err.max():.2f} Hz   "
          f"worst steady-state found frac: {worst_found:.4f}")
    ok = (int((summary['locked'] > 0.5).sum()) == args.channels
          and freq_err.max() < 5.0 and worst_found > 0.85)
    print("PASS" if ok else "FAIL")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
