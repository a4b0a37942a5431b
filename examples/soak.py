"""Hours-scale soak: the full receiver loop over 2+ hours of signal
with every stateful accuracy feature on and a mid-run checkpoint/resume
(VERDICT r2 #7; serving dimension + fast synth added per VERDICT r4 #8).

What this proves that unit tests cannot: the hi/lo long-counter
machinery (tracking.py ms_time / prev_stream hi-lo transport and
checkpoint planes) and the 20 ms bit framing survive millions of blocks without
desync, and the fix error stays flat from the first ten minutes to the
last — through a checkpoint/resume boundary in the middle.

Two modes:
  * --streams 1 (default): one Session through the fused device path
    (checkpoint via runtime/checkpoint.py save_session/load_session).
  * --streams S>1: S full receivers through StreamServer — the serving
    path — evaluated cross-stream (process_many), checkpointed mid-run
    with save_server/load_server; asserts per-stream flat error and
    zero framing desyncs on EVERY stream.

The IQ is synthesized on-device chunk by chunk (DeviceScenarioSynth
with knot_interp_step=0.1: exact light-time solves only at 0.1 s
nodes, Catmull-Rom to the 1 ms knots — ~3e-15 s interp error, and the
host parameterization cost drops ~6x).

Usage: python examples/soak.py [--hours 2] [--k 16] [--streams 8]
                               [--cpu]
Writes chiprun_out/soak.json (--out, relative to the repo root).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--hours", type=float, default=2.0)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--sats", type=int, default=8)
    ap.add_argument("--streams", type=int, default=1)
    ap.add_argument("--out", default="chiprun_out/soak.json")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from gps_sdr.utils.profiling import enable_compile_cache
    enable_compile_cache()

    from gps_sdr.config import ReceiverConfig
    from gps_sdr.models.scenario import make_scenario
    from gps_sdr.models.scenario_jax import DeviceScenarioSynth
    from gps_sdr.runtime.checkpoint import (load_server,
                                            load_session,
                                            save_server,
                                            save_session)
    from gps_sdr.runtime.session import Session

    cfg = ReceiverConfig(blocks_per_step=args.k,
                         carrier_smoothing=16,
                         track_filter_q=(0.5 if args.streams == 1
                                         else 0.0),
                         raim=args.streams == 1,
                         download_windows_in_flight=2,
                         chunks_per_download=16,
                         defer_subframe_poll=True,
                         epoch_per_window=True)
    sig_sec = args.hours * 3600.0
    n_chunks = int(round(sig_sec / (cfg.no_sec * cfg.block_sec)))
    scn = make_scenario(cfg, n_sats=args.sats,
                        duration_sec=sig_sec + 12.0, seed=2)
    dev = DeviceScenarioSynth(scn, noise_std=0.5, knot_interp_step=0.1)

    t_start = time.time()
    half = n_chunks // 2
    t = cfg.no_sec

    def provider(offset_chunks):
        def p(first, n):
            return dev.chunk_planar(offset_chunks * t + first, n)
        return p

    print(f"soak: {sig_sec:.0f} s of signal, {n_chunks} chunks, "
          f"K={args.k}, streams={args.streams}, "
          f"backend={jax.default_backend()}", flush=True)
    ckpt = os.path.join(tempfile.gettempdir(), "soak_ckpt.pkl")

    if args.streams == 1:
        s1 = Session(cfg)
        s1.run_device_source(provider(0), half)
        consumed = s1.receiver.status.blocks_processed
        save_session(s1, ckpt)
        print(f"half done ({consumed} blocks, "
              f"{time.time() - t_start:.0f}s wall); checkpointed "
              f"{os.path.getsize(ckpt)//1024} KB", flush=True)
        s2 = load_session(ckpt)
        s2.run_device_source(provider(half), n_chunks - half)
        evs = [s2.evaluator]
        states_list = [s2.receiver.states]
    else:
        from gps_sdr.runtime.evaluator import Evaluator, process_many
        from gps_sdr.runtime.serving import StreamServer

        def serve(srv, evs, prov, chunks):
            pend = []
            for s, epoch in srv.run(prov, chunks):
                pend.append((evs[s], epoch))
                if len(pend) == len(evs):
                    process_many(pend)
                    pend = []
            if pend:
                process_many(pend)

        srv1 = StreamServer(cfg, args.streams)
        evs = [Evaluator(cfg) for _ in range(args.streams)]
        serve(srv1, evs, provider(0), half)
        consumed = srv1.receivers[0].status.blocks_processed
        save_server(srv1, evs, ckpt)
        print(f"half done ({consumed} blocks/stream, "
              f"{time.time() - t_start:.0f}s wall); checkpointed "
              f"{os.path.getsize(ckpt)//1024} KB", flush=True)
        srv2, evs = load_server(ckpt)
        serve(srv2, evs, provider(half), n_chunks - half)
        states_list = [r.states for r in srv2.receivers]

    wall = time.time() - t_start

    from gps_sdr.ops.tracking import summarize_states

    per_stream = []
    ok_all = True
    for si, ev in enumerate(evs):
        pos = np.array([p for p in ev.positions],
                       np.float64).reshape(-1, 4)
        if len(pos) == 0:
            per_stream.append({"stream": si, "fixes": 0, "pass": False})
            ok_all = False
            continue
        err = np.linalg.norm(pos[:, 1:4] - scn.rec_ecef, axis=1)
        t_rel = pos[:, 0] - pos[0, 0]
        mid_t = t_rel[-1] / 2
        e1 = float(err[t_rel < mid_t].mean())
        e2 = float(err[t_rel >= mid_t].mean())
        states = {k: np.asarray(v) for k, v in
                  summarize_states(cfg, states_list[si]).items()}
        locked_end = int(states["locked"].sum())
        unhealthy = sum(1 for m in ev.err_msgs.values()
                        if m == "UNHEALTHY")
        flat = e2 < max(2.0 * e1, e1 + 2.0)
        s_ok = bool(flat and ev.n_phase_errors == 0 and unhealthy == 0
                    and locked_end >= args.sats - 1
                    and len(pos) > 0.8 * sig_sec
                    * (1024 // cfg.n_cyc) / cfg.no_sec)
        ok_all = ok_all and s_ok
        per_stream.append({
            "stream": si, "fixes": int(len(pos)),
            "err_mean_m": round(float(err.mean()), 2),
            "err_first_half_m": round(e1, 2),
            "err_second_half_m": round(e2, 2),
            "n_phase_errors": int(ev.n_phase_errors),
            "unhealthy_decodes": int(unhealthy),
            "n_outliers": int(len(ev.outliers)),
            "locked_channels_end": locked_end,
            "pass": s_ok,
        })

    # per-10-minute profile of stream 0 ("flat" = no late-run drift)
    ev0 = evs[0]
    pos0 = np.array(ev0.positions, np.float64).reshape(-1, 4)
    profile = []
    if len(pos0):
        err0 = np.linalg.norm(pos0[:, 1:4] - scn.rec_ecef, axis=1)
        tr0 = pos0[:, 0] - pos0[0, 0]
        for q0 in np.arange(0, tr0[-1], 600.0):
            m = (tr0 >= q0) & (tr0 < q0 + 600.0)
            if m.any():
                profile.append(round(float(err0[m].mean()), 2))

    doc = {
        "signal_sec": sig_sec,
        "streams": args.streams,
        "aggregate_signal_sec": sig_sec * args.streams,
        "wall_sec": round(wall, 1),
        "rtf": round(sig_sec / wall, 1),
        "aggregate_rtf": round(sig_sec * args.streams / wall, 1),
        "k": args.k,
        "backend": jax.default_backend(),
        "features": ("carrier_smoothing=16 "
                     + ("track_filter raim" if args.streams == 1
                        else "serving process_many")),
        "synth": "knot_interp_step=0.1 (Catmull-Rom light-time nodes)",
        "checkpoint_at_blocks": int(consumed),
        "err_per_10min_m_stream0": profile,
        "per_stream": per_stream,
        "pass": bool(ok_all),
    }
    out = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
    print(json.dumps(doc), flush=True)
    print(f"wrote {out} — {'PASS' if doc['pass'] else 'FAIL'}",
          flush=True)
    return 0 if doc["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
