"""Command-line launcher for the receiver.

Replaces the reference's launcher + flag module (src/gpssdr.py,
src/gpsglob.py run-mode constants LIVE_MEAS / BIN_DATA / LOAD_PICKLE /
SAVE_PICKLE / SEND_OVER_UDP / LOAD_EPHEM / START_STREAM ...): every
run-mode global becomes an explicit argument, and the two-process UDP
topology becomes `--role recv` / `--role eval` (runtime/transport.py).

Examples:
    python -m gps_sdr replay capture.bin --ui headless --out run1
    python -m gps_sdr synth --sec 40 --sats 6 --ui plot
    python -m gps_sdr live --ui plot --ephem-cache eph.json
    python -m gps_sdr epochs run1_epochs.pickle        # fixture replay
    python -m gps_sdr replay capture.bin --role recv --udp-to 10.0.0.2
    python -m gps_sdr eval --role eval --ui plot       # other machine
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from gps_sdr.config import ReceiverConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="gps_sdr",
        description="GPS L1 C/A software receiver on JAX")
    sub = ap.add_subparsers(dest="mode", required=True)

    def common(p):
        p.add_argument("--n-cyc", type=int, default=32, choices=(8, 16, 32),
                       help="code periods per block (32 -> 32 ms epochs)")
        p.add_argument("--max-sat", type=int, default=11)
        p.add_argument("--conf-height", type=float, default=None,
                       metavar="METERS",
                       help="constrain GPS height (enables 3-sat fixes)")
        p.add_argument("--ui", choices=("headless", "plot", "none"),
                       default="headless")
        p.add_argument("--out", default=None,
                       help="prefix for JSON result dumps")
        p.add_argument("--save-track", action="store_true",
                       help="write a GPX track next to --out")
        p.add_argument("--save-map", action="store_true",
                       help="write a standalone HTML map next to --out")
        p.add_argument("--ephem-cache", default=None,
                       help="JSON ephemeris cache (2 h warm start)")
        p.add_argument("--record-epochs", default=None,
                       help="record receiver->evaluator epochs (fixture)")
        p.add_argument("--role", choices=("both", "recv", "eval"),
                       default="both")
        p.add_argument("--udp-to", default="127.0.0.1",
                       help="evaluator host for --role recv")
        p.add_argument("--max-sec", type=float, default=None,
                       help="stop after this much stream time")
        p.add_argument("--save-state", default=None, metavar="PATH",
                       help="checkpoint the full receiver+evaluator "
                            "state at exit (runtime/checkpoint.py)")
        p.add_argument("--resume-state", default=None, metavar="PATH",
                       help="resume from a --save-state checkpoint "
                            "(continues mid-stream: locked channels, "
                            "bit framing, and time references intact)")
        p.add_argument("--solve-clock-rate", action="store_true",
                       help="estimate the receiver sample-clock skew "
                            "from the common carrier offset and "
                            "de-bias pseudoranges (use when the SDR's "
                            "ppm correction is unknown; replaces the "
                            "reference's SDR_FREQCORR calibration)")
        p.add_argument("--carrier-smoothing", type=int, default=0,
                       metavar="N",
                       help="Hatch-filter window in blocks (0 = off): "
                            "smooth pseudoranges with the tracked "
                            "carrier's integrated Doppler")
        p.add_argument("--almanac-cache", default=None, metavar="PATH",
                       help="JSON almanac + iono-coefficient cache "
                            "(decoded SF4/5 pages; written at exit, "
                            "preloaded at start — valid for weeks)")
        p.add_argument("--warm-start", default=None,
                       metavar="LAT,LON[,ALT[,TOW]]",
                       help="arm an almanac warm start: predict the "
                            "visible PRNs/Dopplers at this rough "
                            "position (and optional GPS TOW; default: "
                            "now) and shrink the cold sweep; needs "
                            "--almanac-cache with a valid almanac")
        p.add_argument("--iono-corr", action="store_true",
                       help="correct pseudoranges with the Klobuchar "
                            "ionosphere model from the decoded "
                            "subframe-4 page-18 coefficients")
        p.add_argument("--tropo-corr", action="store_true",
                       help="correct pseudoranges with the "
                            "Saastamoinen troposphere model")
        p.add_argument("--acq-noncoherent", type=int, default=1,
                       metavar="K",
                       help="average acquisition correlation magnitude "
                            "over K 4 ms windows (8 = whole block, "
                            "~4 dB more sensitivity; 1 = reference)")
        p.add_argument("--track-filter", type=float, default=0.0,
                       metavar="Q",
                       help="enable the position/velocity Kalman track "
                            "filter with white-acceleration process "
                            "noise Q m/s^2 (~0.5 walking, ~3 driving)")

    p = sub.add_parser("replay", help="replay a recorded IQ capture")
    p.add_argument("path")
    p.add_argument("--start-stream", type=int, default=0,
                   help="skip this many blocks first (START_STREAM)")
    p.add_argument("--input-rate", type=float, default=None,
                   metavar="HZ",
                   help="capture sample rate if it exceeds the "
                        "processing rate (integer multiple): the "
                        "digital front end decimates it on-device")
    p.add_argument("--input-if", type=float, default=0.0, metavar="HZ",
                   help="IF of a REAL-sampled capture (digital "
                        "downconversion; use with --input-format "
                        "real16)")
    p.add_argument("--input-format", choices=("iq8", "real16"),
                   default="iq8",
                   help="capture sample format (iq8 = the reference's "
                        "packed uint16 IQ)")
    common(p)

    p = sub.add_parser("synth", help="run on a synthetic scenario")
    p.add_argument("--sec", type=float, default=40.0)
    p.add_argument("--sats", type=int, default=6)
    p.add_argument("--noise", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=3)
    common(p)

    p = sub.add_parser("live", help="live RTL-SDR capture (needs pyrtlsdr)")
    p.add_argument("--gain-db", type=float, default=50.0)
    p.add_argument("--record-iq", default=None,
                   help="also record the capture (gpsbin.py's role)")
    common(p)

    p = sub.add_parser("epochs", help="replay a recorded epoch fixture "
                       "through the evaluator only (LOAD_PICKLE)")
    p.add_argument("path")
    p.add_argument("--then-udp", action="store_true",
                   help="at fixture end, keep listening for live epochs "
                        "over UDP (the reference's LOAD_PICKLE "
                        "fall-through, gpseval.py:516-524)")
    common(p)

    p = sub.add_parser("eval", help="evaluator half of the two-process "
                       "topology (listens on UDP)")
    common(p)

    p = sub.add_parser("serve", help="serve S receiver replicas of one "
                       "IQ source through the stream-stacked device "
                       "program (runtime/serving.py StreamServer): "
                       "throughput mode, cross-stream batched "
                       "evaluation")
    p.add_argument("source", help="recorded .bin capture (iq8) or the "
                   "literal 'synth' for a synthetic scenario")
    p.add_argument("--streams", type=int, default=8)
    p.add_argument("--sec", type=float, default=40.0,
                   help="synth scenario length [s]")
    p.add_argument("--sats", type=int, default=6)
    p.add_argument("--noise", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--n-cyc", type=int, default=32, choices=(8, 16, 32))
    p.add_argument("--max-sat", type=int, default=11)
    p.add_argument("--conf-height", type=float, default=None,
                   metavar="METERS")
    p.add_argument("--carrier-smoothing", type=int, default=0,
                   metavar="N")
    p.add_argument("--max-sec", type=float, default=None)
    p.add_argument("--out", default=None,
                   help="prefix for per-stream JSON result dumps "
                        "(<out>_s<k>_gps*.json)")
    p.add_argument("--save-state", default=None, metavar="PATH",
                   help="checkpoint every stream's receiver+evaluator "
                        "at exit (runtime/checkpoint.py save_server)")
    p.add_argument("--resume-state", default=None, metavar="PATH",
                   help="resume all streams from a save-state "
                        "checkpoint")
    p.add_argument("--windows", type=int, default=16,
                   help="chunks per fused download window")

    p = sub.add_parser("snapshot", help="coarse-time snapshot fix from "
                       "one block of a capture — no nav decode; needs "
                       "cached ephemerides + a coarse position/time "
                       "prior (ops/snapshot.py)")
    p.add_argument("path", help="recorded IQ capture (.bin, iq8)")
    p.add_argument("--ephem-cache", required=True, metavar="PATH",
                   help="ephemeris JSON cache (save with --ephem-cache "
                        "on a normal run)")
    p.add_argument("--prior-geo", required=True, metavar="LAT,LON,H",
                   help="coarse position prior, good to ~100 km")
    p.add_argument("--tow", type=float, required=True,
                   help="coarse GPS time of week at capture start [s], "
                        "good to ~1 min")
    p.add_argument("--start-stream", type=int, default=0,
                   help="block number of the capture to snapshot")
    p.add_argument("--n-cyc", type=int, default=32, choices=(8, 16, 32))
    p.add_argument("--height", type=float, default=None,
                   help="WGS84 height constraint [m] (4-sat fixes)")
    return ap


def run_snapshot(args) -> int:
    """One-block coarse-time fix from a capture + cached ephemerides."""
    from gps_sdr.config import GPS_C
    from gps_sdr.ops import cacode
    from gps_sdr.ops.snapshot import snapshot_fix
    from gps_sdr.runtime.sources import replay_blocks
    from gps_sdr.utils.geodesy import ecef_to_geo, geo_to_ecef
    from gps_sdr.utils.io import load_ephemerides

    cfg = ReceiverConfig(n_cyc=args.n_cyc)
    ephs = load_ephemerides(args.ephem_cache)
    # a normal cache only holds ephem_ok entries, but a hand-edited or
    # third-party file may carry partial dicts — require the full key
    # set _stack_ephs needs and report what was skipped
    from gps_sdr.models.pseudorange import EPHEM_KEYS
    complete = {prn: e for prn, e in ephs.items()
                if isinstance(e, dict) and all(k in e for k in EPHEM_KEYS)}
    skipped = sorted(set(ephs) - set(complete))
    if skipped:
        print(f"snapshot: skipping PRNs with incomplete ephemeris: "
              f"{skipped}", file=sys.stderr)
    ephs = complete
    if not ephs:
        print("error: ephemeris cache empty, expired, or not decoded",
              file=sys.stderr)
        return 2
    lat, lon, h = (float(v) for v in args.prior_geo.split(","))
    prior = np.asarray(geo_to_ecef(lat, lon, h), np.float64)
    block = None
    for block in replay_blocks(args.path, cfg,
                               start_stream=args.start_stream,
                               max_blocks=1):
        break
    if block is None:
        print("error: capture shorter than start stream", file=sys.stderr)
        return 2
    t_gps = args.tow + args.start_stream * cfg.block_sec
    res = snapshot_fix(cfg, block, cacode.ca_fft_table(cfg), ephs,
                       t_gps, prior, height=args.height)
    if res is None:
        print("snapshot: not enough acquired satellites with ephemeris")
        return 1
    gla, glo, gal = ecef_to_geo(res.rec_pos)
    # a mis-resolved millisecond integer (prior outside the ~150 km /
    # ~1 min validity) leaves hundreds of meters of post-fit residual:
    # flag the fix rather than print it as trustworthy
    suspect = res.residual_m > 300.0 or not res.converged
    if suspect:
        print("snapshot: WARNING - fix is suspect "
              f"(residual {res.residual_m:.0f} m, converged="
              f"{res.converged}); check the position/time prior",
              file=sys.stderr)
    print(f"snapshot fix: {gla:.6f} deg, {glo:.6f} deg, {gal:.1f} m "
          f"(n_sat={res.n_sat}, resid {res.residual_m:.1f} m)")
    print(f"  ecef: {res.rec_pos[0]:.1f} {res.rec_pos[1]:.1f} "
          f"{res.rec_pos[2]:.1f} m")
    print(f"  corrected tow: {res.t_gps:.4f} s "
          f"(coarse-time error {res.dt_s:+.4f} s, "
          f"clock bias {res.clock_bias_m / GPS_C * 1e3:+.4f} ms)")
    return 0


def run_serve(args) -> int:
    """S receiver replicas off one chip (the serving path): fused
    window dispatch, sparse window consume, cross-stream batched
    evaluation (process_many) — the product form of what bench.py's
    serving section measures."""
    import jax.numpy as jnp

    from gps_sdr.runtime.checkpoint import load_server, save_server
    from gps_sdr.runtime.evaluator import Evaluator, process_many
    from gps_sdr.runtime.serving import StreamServer

    kw = dict(n_cyc=args.n_cyc, max_sat=args.max_sat,
              chunks_per_download=args.windows,
              download_windows_in_flight=4,
              defer_subframe_poll=True, epoch_per_window=True)
    if args.conf_height is not None:
        kw.update(conf_height=True, height=args.conf_height)
    if args.carrier_smoothing:
        kw.update(carrier_smoothing=args.carrier_smoothing)
    cfg = ReceiverConfig(**kw)
    t = cfg.no_sec

    if args.source == "synth":
        from gps_sdr.models.scenario import make_scenario
        from gps_sdr.models.scenario_jax import DeviceScenarioSynth
        sec = args.sec if args.max_sec is None else min(args.sec,
                                                        args.max_sec)
        scn = make_scenario(cfg, n_sats=args.sats, seed=args.seed,
                            duration_sec=sec + 12.0)
        dev = DeviceScenarioSynth(scn, noise_std=args.noise,
                                  knot_interp_step=0.1)
        n_chunks = int(sec / (t * cfg.block_sec))
        provider = dev.chunk_planar
        truth = scn.rec_ecef
    else:
        from gps_sdr.ops.tracking import to_grouped_planar
        from gps_sdr.runtime.sources import replay_blocks
        max_blocks = (None if args.max_sec is None
                      else int(args.max_sec / cfg.block_sec))
        blocks = np.stack(list(replay_blocks(
            args.source, cfg, max_blocks=max_blocks)))
        n_chunks = blocks.shape[0] // t
        buf = jnp.asarray(
            to_grouped_planar(cfg, blocks[:n_chunks * t]))
        del blocks
        truth = None

        def provider(first, n):
            import jax
            return jax.lax.dynamic_slice_in_dim(buf, int(first), n)

    if args.resume_state:
        srv, evs = load_server(args.resume_state)
        if srv.n_streams != args.streams:
            print(f"note: checkpoint has {srv.n_streams} streams; "
                  f"ignoring --streams {args.streams}")
    else:
        srv = StreamServer(cfg, args.streams)
        evs = [Evaluator(cfg) for _ in range(srv.n_streams)]

    t0 = time.time()
    pend = []
    for s, epoch in srv.run(provider, n_chunks):
        pend.append((evs[s], epoch))
        if len(pend) == srv.n_streams:
            process_many(pend)
            pend = []
    if pend:
        process_many(pend)
    wall = time.time() - t0
    sig = n_chunks * t * cfg.block_sec

    for s, ev in enumerate(evs):
        n_fix = len(ev.positions)
        line = f"stream {s}: {n_fix} fixes"
        if n_fix and ev.stat is not None:
            line += (f", mean ECEF ({ev.stat[0][0]:.1f}, "
                     f"{ev.stat[0][1]:.1f}, {ev.stat[0][2]:.1f})")
            if truth is not None:
                err = float(np.linalg.norm(ev.stat[0] - truth))
                line += f", err vs truth {err:.2f} m"
        print(line)
    print(f"{srv.n_streams} streams x {sig:.0f} s in {wall:.1f} s "
          f"= {srv.n_streams * sig / wall:.0f}x aggregate realtime; "
          f"stages {{{', '.join(f'{k}: {v:.2f}' for k, v in srv.perf.items())}}}")

    if args.out:
        from gps_sdr.utils import io
        for s, ev in enumerate(evs):
            io.save_results(f"{args.out}_s{s}",
                            sat_results=ev.sat_results,
                            positions=ev.positions)
    if args.save_state:
        save_server(srv, evs, args.save_state)
        print(f"checkpointed {srv.n_streams} streams to "
              f"{args.save_state}")
    return 0


def make_config(args) -> ReceiverConfig:
    kw = dict(n_cyc=args.n_cyc, max_sat=args.max_sat)
    if args.conf_height is not None:
        kw.update(conf_height=True, height=args.conf_height)
    if getattr(args, "solve_clock_rate", False):
        kw.update(solve_clock_rate=True)
    if getattr(args, "carrier_smoothing", 0):
        kw.update(carrier_smoothing=args.carrier_smoothing)
    if getattr(args, "iono_corr", False):
        kw.update(iono_corr=True)
    if getattr(args, "tropo_corr", False):
        kw.update(tropo_corr=True)
    if getattr(args, "track_filter", 0.0):
        kw.update(track_filter_q=args.track_filter)
    if getattr(args, "acq_noncoherent", 1) > 1:
        kw.update(acq_noncoherent=args.acq_noncoherent)
    return ReceiverConfig(**kw)


def make_reporter(args):
    if args.ui == "headless":
        from gps_sdr.ui.headless import HeadlessReporter
        return HeadlessReporter()
    if args.ui == "plot":
        from gps_sdr.ui.plot import PlotUI
        return PlotUI()
    return None


def block_source(args, cfg):
    if args.mode == "replay":
        from gps_sdr.runtime.sources import (replay_blocks,
                                             replay_decimated)
        max_blocks = (None if args.max_sec is None
                      else int(args.max_sec / cfg.block_sec))
        if getattr(args, "input_rate", None):
            return replay_decimated(args.path, cfg, args.input_rate,
                                    f_if=args.input_if,
                                    fmt=args.input_format,
                                    start_stream=args.start_stream,
                                    max_blocks=max_blocks)
        return replay_blocks(args.path, cfg,
                             start_stream=args.start_stream,
                             max_blocks=max_blocks)
    if args.mode == "synth":
        from gps_sdr.models.scenario import (make_scenario,
                                             synth_scenario_blocks)
        sec = args.sec if args.max_sec is None else min(args.sec,
                                                        args.max_sec)
        scn = make_scenario(cfg, n_sats=args.sats, seed=args.seed,
                            duration_sec=sec + 12.0)
        n_blocks = int(round(sec / cfg.block_sec))

        def gen():
            step = 4 * cfg.no_sec
            for first in range(0, n_blocks, step):
                n = min(step, n_blocks - first)
                chunk = synth_scenario_blocks(scn, first, n,
                                              noise_std=args.noise,
                                              seed=args.seed)
                yield from chunk
        return gen()
    if args.mode == "live":
        from gps_sdr.runtime.sources import live_blocks
        src = live_blocks(cfg, gain_db=args.gain_db)
        if args.record_iq:
            from gps_sdr.runtime.sources import pack_iq

            def recording(src=src, path=args.record_iq):
                with open(path, "wb") as f:
                    for b in src:
                        pack_iq(b).tofile(f)
                        yield b
            src = recording()
        if args.max_sec is not None:
            import itertools
            src = itertools.islice(src, int(args.max_sec / cfg.block_sec))
        return src
    raise ValueError(args.mode)


def run_recv_process(args, cfg) -> int:
    """Receiver half: DSP on device, epochs out over UDP."""
    from gps_sdr.runtime.receiver import Receiver
    from gps_sdr.runtime.transport import EpochSender

    recv = Receiver(cfg)
    sender = EpochSender(host=args.udp_to)
    n = 0
    try:
        for epoch in recv.run(block_source(args, cfg)):
            sender.send(epoch)
            n += 1
            cmd = sender.poll_command()
            if cmd == "SWEEP":
                recv.request_sweep()
            elif cmd == "STOP":
                recv.stop()
    finally:
        sender.close()
    print(f"receiver done: {n} epochs sent")
    return 0


def run_eval_process(args, cfg) -> int:
    """Evaluator half: epochs in over UDP, fixes + UI out."""
    from gps_sdr.runtime.evaluator import Evaluator
    from gps_sdr.runtime.transport import EpochReceiver
    from gps_sdr.utils import io

    preloaded = (io.load_ephemerides(args.ephem_cache)
                 if args.ephem_cache else {})
    ev = Evaluator(cfg, preloaded_ephem=preloaded)
    reporter = make_reporter(args)
    rx = EpochReceiver()
    t0 = time.time()
    idle = 0.0
    try:
        while True:
            epoch = rx.recv()
            if epoch is None:
                time.sleep(0.05)
                idle += 0.05
                if idle > 30.0 or (args.max_sec is not None
                                   and time.time() - t0 > args.max_sec + 30):
                    break
                continue
            idle = 0.0
            summary = ev.process(epoch)
            if reporter is not None:
                reporter.update(epoch.frames, summary, ev)
    except KeyboardInterrupt:
        rx.request_stop()
    finally:
        rx.close()
    _save_outputs(args, cfg, ev)
    return 0


def _save_outputs(args, cfg, ev) -> None:
    from gps_sdr.utils import io

    if args.out:
        io.save_results(args.out, sat_results=ev.sat_results,
                        positions=ev.positions,
                        velocities=ev.velocities or None,
                        filtered=ev.filtered or None)
    if args.ephem_cache:
        io.save_ephemerides(args.ephem_cache,
                            {s: e.ephem for s, e in ev.engines.items()
                             if e.ephem_ok})
    if args.out and ev.positions:
        from gps_sdr.utils.geodesy import ecef_to_geo
        track = [ecef_to_geo(p[1:]) for p in ev.positions]
        if args.save_track:
            io.save_gpx_track(f"{args.out}_track.gpx", track)
        if args.save_map and ev.stat is not None:
            from gps_sdr.ui.webmap import save_map
            save_map(f"{args.out}_map.html", ecef_to_geo(ev.stat[0]), track)


def _arm_warm_start(spec: str, session) -> None:
    """--warm-start LAT,LON[,ALT[,TOW]]: shrink the cold sweep from the
    cached almanac (models/almanac.py; the reference always sweeps all
    31 PRNs over the full band)."""
    from gps_sdr.utils.geodesy import geo_to_ecef
    from gps_sdr.utils.gpstime import gps_week_tow

    parts = [float(v) for v in spec.split(",")]
    lat, lon = parts[0], parts[1]
    alt = parts[2] if len(parts) > 2 else 0.0
    tow = int(parts[3]) if len(parts) > 3 else gps_week_tow()[1]
    alms = session.evaluator.almanacs
    if not alms:
        print("warm start: no almanac cached - full sweep")
        return
    ok = session.receiver.warm_start(alms, geo_to_ecef(lat, lon, alt),
                                     tow)
    print("warm start: sweep narrowed to "
          f"{len(session.receiver.warm_hints[0])} PRNs" if ok
          else "warm start: too few predicted sats - full sweep")


def run_in_process(args, cfg) -> int:
    """Default single-process topology via Session."""
    from gps_sdr.runtime.session import Session

    if args.resume_state:
        from gps_sdr.runtime.checkpoint import load_session
        session = load_session(args.resume_state,
                               reporter=make_reporter(args))
        session.record_epochs_to = args.record_epochs
        # the checkpoint's config governs the resumed run: the restored
        # tracking state was compiled for its block framing, so the
        # block source must use it too (CLI shape flags are ignored on
        # resume; the evaluator already carries its ephemerides, so
        # --ephem-cache only affects the exit-time save)
        if cfg.n_cyc != session.cfg.n_cyc:
            print(f"resume: using checkpoint n_cyc={session.cfg.n_cyc} "
                  f"(ignoring --n-cyc {cfg.n_cyc})")
        cfg = session.cfg
        session.ephem_cache_path = args.ephem_cache
        if args.mode == "replay" and args.start_stream == 0:
            # continue the capture where the saved run stopped
            args.start_stream = session.receiver.status.stream_no
            print(f"resume: continuing at stream block "
                  f"{args.start_stream}")
    else:
        session = Session(cfg, ephem_cache_path=args.ephem_cache,
                          almanac_cache_path=getattr(
                              args, "almanac_cache", None),
                          record_epochs_to=args.record_epochs,
                          reporter=make_reporter(args))
    if getattr(args, "warm_start", None):
        _arm_warm_start(args.warm_start, session)
    n_prior_epochs = len(session.summaries)
    if args.mode == "epochs":
        from gps_sdr.utils.io import load_epoch_records
        summary = session.run_epoch_records(load_epoch_records(args.path))
        if args.then_udp:
            summary = session.run_udp_followup(max_sec=args.max_sec)
    else:
        t0 = time.time()
        summary = session.run_source(block_source(args, cfg))
        wall = time.time() - t0
        sec = session.evaluator and \
            (len(session.summaries) - n_prior_epochs) * cfg.no_sec \
            * cfg.block_sec
        print(f"processed {sec:.1f} s of stream in {wall:.1f} s "
              f"({sec / max(wall, 1e-9):.1f}x realtime)")
    if args.save_state:
        from gps_sdr.runtime.checkpoint import save_session
        save_session(session, args.save_state)
        print(f"checkpoint saved to {args.save_state}")
    if args.out or args.ephem_cache:
        _save_outputs(args, cfg, session.evaluator)
    if args.record_epochs:
        from gps_sdr.utils.io import save_epoch_records
        save_epoch_records(args.record_epochs, session.records)
    stat = summary.get("stat")
    print(f"fixes: {summary['n_positions']}  "
          f"failures: {summary['n_fix_failures']}  "
          f"outliers: {summary['n_outliers']}  "
          f"phase errors: {summary['n_phase_errors']}  "
          f"skipped blocks: {summary['skipped_blocks']}")
    if stat is not None:
        from gps_sdr.utils.geodesy import ecef_to_geo
        mean, dev, n, _ = stat
        lat, lon, alt = ecef_to_geo(mean)
        print(f"mean position: {lat:.6f} deg, {lon:.6f} deg, {alt:.1f} m "
              f"(n={n}, sd {np.linalg.norm(dev):.2f} m)")
    else:
        print("no position fix")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mode == "snapshot":
        return run_snapshot(args)
    if args.mode == "serve":
        return run_serve(args)
    cfg = make_config(args)
    if args.mode == "eval" or args.role == "eval" or args.role == "recv":
        if getattr(args, "save_state", None) \
                or getattr(args, "resume_state", None):
            print("error: --save-state/--resume-state are only "
                  "supported in the single-process topology "
                  "(--role both)", file=sys.stderr)
            return 2
    if args.mode == "eval" or args.role == "eval":
        return run_eval_process(args, cfg)
    if args.role == "recv":
        return run_recv_process(args, cfg)
    return run_in_process(args, cfg)


if __name__ == "__main__":
    sys.exit(main())
