"""Per-stage device times of the receiver's device path, from profiler
traces, beside the card's memory-bandwidth floor.

Each stage runs as its own jitted program at product geometry (12
channels, 2048-sample codes, n_cyc=32, K = blocks_per_step) inside a
jax.profiler trace window of `--reps` calls; device time is the union of
the device's operation intervals (utils/profiling.device_time_from_trace)
divided by the calls.  Stages:

  heavy      heavy_stage: frozen-NCO mix, correlation DFTs, wipeoff sums
             (one K-block step)
  cheap      channel_step_k vmapped over channels: the sequential
             K-block feedback scan (one step)
  track      track_chunk_batched over --blocks blocks (heavy + cheap in
             one scan)
  dft_*      jnp.fft at the tracking and acquisition batch shapes
  acq_*      full-grid acquisition (31 PRN x 51 Doppler) at 2048- and
             16384-sample codes

Prints one JSON object per stage and writes all of them to --out.  Needs
a GPU: a trace without a device lane is refused.

Usage: python examples/roofline.py [--blocks 256] [--reps 20]
                                   [--out chiprun_out/stage_times.json]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

# Published peaks by device_kind (NVIDIA H100 SXM data sheet; the
# rates assume the full 700 W power limit).  An unlisted device is an
# error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def stages(cfg, n_blocks: int):
    """{name: (fn, args, blocks_per_call)} at product geometry."""
    import jax
    import jax.numpy as jnp

    from gps_sdr.models.scenario import make_scenario
    from gps_sdr.models.scenario_jax import DeviceScenarioSynth
    from gps_sdr.ops import cacode
    from gps_sdr.ops.acquisition import acquire_impl
    from gps_sdr.ops.dsp import as_complex_input
    from gps_sdr.ops.tracking import (channel_step_k, heavy_stage,
                                      init_channel_states, reset_channel,
                                      to_f32_pairs,
                                      track_chunk_batched_impl)

    n_ch, k = cfg.max_sat, cfg.blocks_per_step
    scn = make_scenario(cfg, n_sats=10, seed=3,
                        duration_sec=n_blocks * cfg.block_sec + 12.0)
    dev = DeviceScenarioSynth(scn, noise_std=0.5)
    blocks = dev.chunk_planar(0, n_blocks)
    ftab = cacode.ca_fft_table(cfg)
    prns = [s.prn for s in scn.sats]
    prns = (prns * n_ch)[:n_ch]
    ffts = jnp.asarray(to_f32_pairs(np.stack([ftab[p] for p in prns])))
    codes = jnp.zeros((n_ch, cfg.code_samples), jnp.float32)
    st = init_channel_states(cfg, n_ch)
    for i, p in enumerate(prns):
        st = reset_channel(st, i, p, 1000.0, 100, cfg)

    blk_k = jax.jit(as_complex_input)(blocks[:k])
    ffts_c = as_complex_input(ffts)
    heavy = jax.jit(lambda s, b, f: heavy_stage(cfg, k, s, b, f))
    hout = heavy(st, blk_k, ffts_c)
    cheap = jax.jit(jax.vmap(functools.partial(channel_step_k, cfg, k),
                             in_axes=(0, 0, None)))
    track = jax.jit(functools.partial(track_chunk_batched_impl, cfg))

    out = {
        "heavy": (heavy, (st, blk_k, ffts_c), k),
        "cheap": (cheap, (st, hout, jnp.int32(1)), k),
        "track": (lambda b: track(st, b, jnp.float32(1), codes, ffts),
                  (blocks,), n_blocks),
    }
    rng = np.random.default_rng(0)
    fft = jax.jit(lambda x: jnp.fft.fft(x, axis=-1))
    for n, b, tag in ((2048, 3 * n_ch * k, "track_step"),
                      (2048, 32 * cfg.n_doppler, "acq"),
                      (16384, 32 * cfg.n_doppler, "acq16")):
        x = jnp.asarray((rng.standard_normal((b, n))
                         + 1j * rng.standard_normal((b, n)))
                        .astype(np.complex64))
        out[f"dft_n{n}_b{b}_{tag}"] = (fft, (x,), None)
    for cs, n_cyc in ((2048, 32), (16384, 8)):
        c = cfg.replace(code_samples=cs, n_cyc=n_cyc,
                        sweep_corr_avg=4 if cs == 2048 else 2)
        tab = cacode.ca_fft_table(c)[np.asarray(c.prns)]
        blk = jnp.asarray(rng.standard_normal((c.ngps, 2))
                          .astype(np.float32))
        out[f"acq_{cs}"] = (
            jax.jit(functools.partial(acquire_impl, c)),
            (blk, jnp.asarray(c.doppler_bins, jnp.float32),
             jnp.asarray(to_f32_pairs(tab))), None)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=256)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default="chiprun_out/stage_times.json")
    args = ap.parse_args()

    import jax

    from gps_sdr.config import ReceiverConfig
    from gps_sdr.utils.profiling import (card_label,
                                         device_time_from_trace,
                                         enable_compile_cache,
                                         op_breakdown_from_trace, trace)

    enable_compile_cache()
    cfg = ReceiverConfig(max_sat=12)
    d0 = jax.devices()[0]
    peaks = PEAKS[d0.device_kind]
    card = card_label()
    print(f"card: {card}  device_kind: {d0.device_kind}", flush=True)

    results = []
    for name, (fn, fargs, n_blk) in stages(cfg, args.blocks).items():
        jax.block_until_ready(fn(*fargs))            # compile + warm
        tdir = tempfile.mkdtemp(prefix=f"stage_{name}_")
        with trace(tdir):
            for _ in range(args.reps):
                jax.block_until_ready(fn(*fargs))
        dev = device_time_from_trace(tdir)
        ops = op_breakdown_from_trace(tdir, top=8)
        shutil.rmtree(tdir, ignore_errors=True)
        rec = {"stage": name, "card": card, "device_kind": d0.device_kind,
               "device_us_per_call": dev["busy_s"] / args.reps * 1e6,
               "span_us_per_call": dev["span_s"] / args.reps * 1e6,
               "ops_per_call": dev["n_ops"] / args.reps,
               "top_ops": [(n[:60], round(t / args.reps * 1e6, 2), c
                            // args.reps) for n, t, c in ops]}
        if n_blk:
            rec["device_us_per_block"] = rec["device_us_per_call"] / n_blk
            # floor: the planar f32 IQ block streamed from HBM once
            floor = 2 * cfg.ngps * 4 / peaks["hbm_bytes_per_s"] * 1e6
            rec["hbm_floor_us_per_block"] = floor
            rec["x_over_hbm_floor"] = rec["device_us_per_block"] / floor
            if name == "track":
                rec["ops_per_k_step"] = (rec["ops_per_call"]
                                         / (n_blk // cfg.blocks_per_step))
                rec["device_rtf"] = cfg.block_sec / (
                    rec["device_us_per_block"] * 1e-6)
        print(json.dumps(rec), flush=True)
        results.append(rec)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
