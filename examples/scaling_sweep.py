"""Time-shard scaling sweep: accuracy + work cost of the stitch modes.

Runs the same 4-channel stream over a (time, ch) mesh at 1/2/4/8 time
shards in both stitch modes and reports, per shard count:

  * the per-device work factor (scans of the local stream needed):
    exact re-scan stitching costs n_shards scans (zero speedup at
    exactness); the boundary-state handoff costs 1 + W/L scans
    (near-linear speedup for warmup W << local length L)
  * measured accuracy vs the sequential oracle (code-phase agreement,
    final carrier-freq delta, lock agreement)
  * wall time on THIS host (virtual CPU mesh: wall does NOT scale
    here — the virtual devices share the host's cores; the work factor
    is the hardware-independent scaling model, validated by the
    accuracy numbers)

Phase 2 (fix-level parity, VERDICT r2 #3): a boundary transient's real
cost is a flipped bit edge -> a lost subframe -> a lost (TOW, ST)
reference, which the tracking-output metrics above cannot see.  A
30 s scenario capture (real nav message) is tracked sequentially and
through the state-handoff stitch at 2/4/8 shards x several warmups;
the SAME nav-decode + evaluator pipeline runs on both outputs and the
rows report subframes decoded, fixes produced, fix error, and the
per-epoch fix separation vs the sequential run.  The documented
operating point is the smallest warmup with zero lost subframes.

Writes chiprun_out/scaling.json (relative to the repo root).

Usage: python examples/scaling_sweep.py [--blocks 64] [--warmup 4]
       [--skip-fix-parity]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=64)
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--channels", type=int, default=4)
    ap.add_argument("--skip-fix-parity", action="store_true")
    ap.add_argument("--fix-sec", type=float, default=30.0)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    from gps_sdr.utils.profiling import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp

    from gps_sdr.config import ReceiverConfig
    from gps_sdr.models.simulator import (SatSignal, random_bits,
                                          synth_stream_chunk)
    from gps_sdr.ops import cacode
    from gps_sdr.ops.tracking import (init_channel_states,
                                      reset_channel, track_chunk)
    from gps_sdr.parallel import make_mesh, pad_channels, track_sharded

    cfg = ReceiverConfig()
    rng = np.random.default_rng(0)
    prns = [5, 12, 21, 29][:args.channels]
    sats = [SatSignal(prn=p, doppler=float(rng.uniform(-4000, 4000)),
                      code_delay=float(rng.uniform(0, 2048)),
                      nav_bits=random_bits(256, seed=p))
            for p in prns]
    t = args.blocks
    print(f"synthesizing {t} blocks ({t * cfg.block_sec:.1f} s)...")
    blocks = synth_stream_chunk(cfg, sats, first_block=0, n_blocks=t,
                                noise_std=0.5, seed=7)
    blocks = jnp.asarray(blocks)

    def fresh():
        st = init_channel_states(cfg, len(sats))
        for i, s in enumerate(sats):
            st = reset_channel(st, i, s.prn, s.doppler,
                               int(s.code_delay), cfg)
        return st

    tab, ftab = cacode.ca_table(cfg), cacode.ca_fft_table(cfg)
    codes = np.stack([tab[s.prn] for s in sats])
    ffts = np.stack([ftab[s.prn] for s in sats])

    ref_states, ref_outs = track_chunk(cfg, fresh(), blocks, jnp.int32(1),
                                       jnp.asarray(codes),
                                       jnp.asarray(ffts))
    jax.block_until_ready(ref_outs.code_phase)
    ref_cp = np.asarray(ref_outs.code_phase)
    ref_freq = np.asarray(ref_states.freq)
    ref_lock = np.asarray(ref_outs.locked)

    rows = []
    for n_sh in (1, 2, 4, 8):
        L = t // n_sh
        for mode, kw, work in (
                ("exact_rescan", dict(n_stitch=n_sh), float(n_sh)),
                ("state_handoff", dict(warmup_blocks=args.warmup),
                 1.0 + (min(args.warmup, L) / L if n_sh > 1 else 0.0))):
            mesh = make_mesh(8, time_shards=n_sh)
            c_size = mesh.shape["ch"]

            def run():
                st0, cod, ff = pad_channels(fresh(), codes, ffts, c_size)
                st, outs = track_sharded(cfg, mesh, st0, blocks,
                                         jnp.int32(1), cod, ff, **kw)
                st = jax.tree.map(lambda x: x[:len(sats)], st)
                outs = jax.tree.map(lambda x: x[:, :len(sats)], outs)
                return st, outs
            st, outs = run()
            jax.block_until_ready(outs.code_phase)     # compile
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                st, outs = run()
                jax.block_until_ready(outs.code_phase)
                walls.append(time.perf_counter() - t0)
            cp = np.asarray(outs.code_phase)
            both = (ref_cp >= 0) & (cp >= 0)
            agree = float((np.abs(ref_cp - cp)[both] < 0.5).mean())
            lock_agree = float(
                (np.asarray(outs.locked) == ref_lock).mean())
            dfreq = float(np.max(np.abs(np.asarray(st.freq) - ref_freq)))
            rows.append({
                "time_shards": n_sh, "mode": mode,
                "work_scans_per_device": round(work, 3),
                "model_speedup": round(n_sh / work, 2),
                "wall_s_1core_host": round(min(walls), 3),
                "code_phase_agreement": round(agree, 4),
                "lock_agreement": round(lock_agree, 4),
                "max_final_freq_err_hz": round(dfreq, 3),
            })
            print(rows[-1])

    # ---- phase 2: fix-level parity through the stitched path ----
    fix_rows = []
    if not args.skip_fix_parity:
        from gps_sdr.models.navmsg import NavDecoder
        from gps_sdr.models.scenario import make_scenario
        from gps_sdr.models.scenario_jax import DeviceScenarioSynth
        from gps_sdr.ops.tracking import outs_to_numpy
        from gps_sdr.runtime.evaluator import EpochInput, Evaluator

        # multiple of 8 so every shard count divides the stream
        fix_blocks = (int(round(args.fix_sec / cfg.block_sec)) // 8) * 8
        scn = make_scenario(cfg, n_sats=6,
                            duration_sec=args.fix_sec + 12.0, seed=2)
        print(f"synthesizing {args.fix_sec:.0f} s scenario capture...")
        dev = DeviceScenarioSynth(scn, noise_std=0.6)
        fb = dev.chunk(0, fix_blocks)
        fb = jnp.asarray(fb)
        fprns = [s.prn for s in scn.sats]
        fcodes = np.stack([tab[p] for p in fprns])
        fffts = np.stack([ftab[p] for p in fprns])
        ephs = {s.prn: {"SAT": s.prn, **s.eph} for s in scn.sats}

        def ffresh():
            st = init_channel_states(cfg, len(fprns))
            # seed from truth: acquisition parity is covered elsewhere,
            # this phase isolates the stitched TRACKING path
            for i, s in enumerate(scn.sats):
                ts = scn.t_rx0 + np.array([0.0, 1.0])
                tau = scn.sat_states(ts, s)[0]
                dop = -1575.42e6 * (tau[1] - tau[0])
                delay = int((tau[0] * cfg.sample_rate) % cfg.code_samples)
                st = reset_channel(st, i, s.prn, float(dop), delay, cfg)
            return st

        def decode_fix(outs_np):
            """The receiver's own per-second decode + evaluate pipeline
            on raw tracking outputs (mirrors Receiver._consume_chunk)."""
            # absolute sample-time bit framing: the channel-relative
            # ms_time counter restarts at stitched warmup seams and
            # would break 20 ms framing at every shard boundary
            decs = [NavDecoder(ngps=cfg.ngps,
                               ms_from_st=cfg.code_samples)
                    for _ in fprns]
            ev = Evaluator(cfg, preloaded_ephem=ephs)
            n_subs = 0
            step = cfg.no_sec
            tt = outs_np.code_phase.shape[0]
            for c0 in range(0, tt, step):
                sl = slice(c0, min(c0 + step, tt))
                stream0 = 1 + c0
                coph, frames = {}, []
                for slot, prn in enumerate(fprns):
                    decs[slot].push_chunk(
                        outs_np.sign0[sl, slot], outs_np.edge_ms[sl, slot],
                        outs_np.edge_local[sl, slot],
                        outs_np.edge_valid[sl, slot],
                        stream_no0=stream0, erased=outs_np.erased[sl, slot])
                    cp = outs_np.code_phase[sl, slot]
                    ok = np.nonzero(cp >= 0)[0]
                    if ok.size:
                        coph[prn] = list(zip(
                            (stream0 + ok).tolist(),
                            cp[ok].astype(float).tolist()))
                    subs = (decs[slot].poll_subframes()
                            if outs_np.locked[sl, slot][-1] else [])
                    if not subs:
                        subs = [{}]
                    for sf in subs:
                        if "ID" in sf:
                            n_subs += 1
                        sf["SAT"] = prn
                        sf["FRQ"] = float(outs_np.freq[sl, slot][-1])
                    frames += subs
                ev.process(EpochInput(0, frames, coph))
            pos = np.array([p[:4] for p in ev.positions], np.float64)
            return n_subs, pos

        rs, ro = track_chunk(cfg, ffresh(), fb, jnp.int32(1),
                             jnp.asarray(fcodes), jnp.asarray(fffts))
        jax.block_until_ready(ro.code_phase)
        ref_subs, ref_pos = decode_fix(outs_to_numpy(ro))
        ref_err = float(np.mean(np.linalg.norm(
            ref_pos[:, 1:4] - scn.rec_ecef, axis=1))) if len(ref_pos) \
            else float("nan")
        print(f"sequential: {ref_subs} subframes, {len(ref_pos)} fixes, "
              f"mean err {ref_err:.2f} m")
        ref_by_t = {round(p[0], 3): p[1:4] for p in ref_pos}

        for n_sh in (2, 4, 8):
            for warm in (2, 4, 8):
                mesh = make_mesh(8, time_shards=n_sh)
                c_size = mesh.shape["ch"]
                st0, cod, ff = pad_channels(ffresh(), fcodes, fffts,
                                            c_size)
                st, outs = track_sharded(cfg, mesh, st0, fb, jnp.int32(1),
                                         cod, ff, warmup_blocks=warm)
                outs = jax.tree.map(lambda x: x[:, :len(fprns)], outs)
                jax.block_until_ready(outs.code_phase)
                subs, pos = decode_fix(outs_to_numpy(outs))
                err = float(np.mean(np.linalg.norm(
                    pos[:, 1:4] - scn.rec_ecef, axis=1))) \
                    if len(pos) else float("nan")
                by_t = {round(p[0], 3): p[1:4] for p in pos}
                common = sorted(set(ref_by_t) & set(by_t))
                sep = (float(np.median([np.linalg.norm(
                    np.subtract(ref_by_t[k], by_t[k])) for k in common]))
                    if common else float("nan"))
                fix_rows.append({
                    "time_shards": n_sh, "warmup_blocks": warm,
                    "mode": "state_handoff",
                    "subframes": subs, "subframes_lost": ref_subs - subs,
                    "fixes": len(pos), "fix_err_m": round(err, 2),
                    "common_epochs": len(common),
                    "median_sep_vs_sequential_m": (round(sep, 3)
                                                   if common else None),
                })
                print(fix_rows[-1])

    doc = {
        "blocks": t, "channels": len(sats), "warmup_blocks": args.warmup,
        "note": ("wall times are from the host CPU hosting all "
                 "8 virtual devices and do not reflect hardware scaling; "
                 "model_speedup = n_shards / work_scans_per_device is the "
                 "hardware-independent scaling, valid while the stitch "
                 "ppermute (a few KB/channel between devices) stays negligible "
                 "next to the per-shard scan"),
        "rows": rows,
        "fix_parity": {
            "sequential": ({"subframes": ref_subs, "fixes": len(ref_pos),
                            "fix_err_m": round(ref_err, 2)}
                           if fix_rows else None),
            "rows": fix_rows,
        },
    }
    out = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chiprun_out", "scaling.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
