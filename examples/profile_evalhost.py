"""Profile the host evaluator ALONE (no device in the loop).

Captures the (stream, EpochInput) pairs of a short CPU serving run
once, then replays them through fresh Evaluators under cProfile.  This
is the pure host cost that caps serving aggregate RTF and the full
loop (the device side is ~3000x realtime) — the target of any native
(C++) host-kernel work.

Usage: python examples/profile_evalhost.py [--sec 32] [--streams 4]
       [--reps 3]
"""

import argparse
import cProfile
import functools
import os
import pickle
import pstats
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gps_sdr.utils.profiling import enable_compile_cache  # noqa: E402
enable_compile_cache()

p = argparse.ArgumentParser()
p.add_argument("--sec", type=float, default=32.0)
p.add_argument("--streams", type=int, default=4)
p.add_argument("--reps", type=int, default=3)
p.add_argument("--cache", default="/tmp/evalhost_epochs.pkl")
args = p.parse_args()

import jax  # noqa: E402
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gps_sdr.config import ReceiverConfig  # noqa: E402
from gps_sdr.models.scenario import make_scenario  # noqa: E402
from gps_sdr.models.scenario_jax import DeviceScenarioSynth  # noqa: E402
from gps_sdr.runtime.evaluator import Evaluator, process_many  # noqa: E402
from gps_sdr.runtime.serving import StreamServer  # noqa: E402

cfg = ReceiverConfig()
n_chunks = int(round(args.sec / (cfg.no_sec * cfg.block_sec)))
w = min(16, max(1, n_chunks // 2))
cfg_sv = cfg.replace(download_windows_in_flight=4,
                     chunks_per_download=w,
                     defer_subframe_poll=True,
                     epoch_per_window=True)

key = (args.sec, args.streams, w)
capture = None
if os.path.exists(args.cache):
    try:
        with open(args.cache, "rb") as f:
            k, capture = pickle.load(f)
        if k != key:
            capture = None
    except Exception:
        capture = None

if capture is None:
    scn = make_scenario(cfg, n_sats=10, seed=5,
                        duration_sec=args.sec + 12.0)
    dsv = DeviceScenarioSynth(scn, noise_std=0.5)
    parts = [dsv.chunk_planar(ci * cfg.no_sec, cfg.no_sec)
             for ci in range(n_chunks)]
    buf = jnp.concatenate(parts)

    @functools.partial(jax.jit, static_argnums=2)
    def _slice(b, first, n):
        return jax.lax.dynamic_slice_in_dim(b, first, n)

    def provider(first, n):
        return _slice(buf, jnp.int32(first), n)

    srv = StreamServer(cfg_sv, args.streams)
    capture = []
    t0 = time.time()
    for s, epoch in srv.run(provider, n_chunks):
        capture.append((s, epoch))
    print(f"captured {len(capture)} epochs in {time.time()-t0:.1f}s",
          flush=True)
    with open(args.cache, "wb") as f:
        pickle.dump((key, capture), f)
else:
    print(f"loaded {len(capture)} cached epochs", flush=True)


def replay_once():
    evs = [Evaluator(cfg_sv) for _ in range(args.streams)]
    pend = []
    for s, epoch in capture:
        pend.append((evs[s], epoch))
        if len(pend) == args.streams:
            process_many(pend)
            pend = []
    if pend:
        process_many(pend)
    return evs


evs = replay_once()                      # warm (jit etc.)
fixes = sum(len(e.positions) for e in evs)
print(f"warm replay: {fixes} fixes total", flush=True)

prof = cProfile.Profile()
t0 = time.perf_counter()
prof.enable()
for _ in range(args.reps):
    evs = replay_once()
prof.disable()
wall = (time.perf_counter() - t0) / args.reps
sig = args.sec * args.streams
print(f"host-only: {sig:.0f}s aggregate signal in {wall:.2f}s/rep "
      f"=> host cap {sig/wall:.0f}x aggregate RTF", flush=True)
st = pstats.Stats(prof)
st.sort_stats("cumulative").print_stats(35)
st.sort_stats("tottime").print_stats(25)
