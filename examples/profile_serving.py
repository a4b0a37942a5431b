"""Profile the HOST side of StreamServer serving-with-fixes (the
aggregate-RTF bench shape): S full receivers off one chip, one
evaluator per stream.  When device tracking is far faster than
realtime, the serving ceiling is the per-chunk host work x S — this
shows where it goes.  Device work runs on the backend JAX selects
(JAX_PLATFORMS=cpu for a CPU run).

Usage: python examples/profile_serving.py [--sec 24] [--streams 8]
"""

import argparse
import cProfile
import functools
import os
import pstats
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gps_sdr.utils.profiling import enable_compile_cache  # noqa: E402
enable_compile_cache()

p = argparse.ArgumentParser()
p.add_argument("--sec", type=float, default=24.0)
p.add_argument("--streams", type=int, default=8)
p.add_argument("--wif", type=int, default=2,
               help="download_windows_in_flight")
args = p.parse_args()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gps_sdr.config import ReceiverConfig  # noqa: E402
from gps_sdr.models.scenario import make_scenario  # noqa: E402
from gps_sdr.models.scenario_jax import DeviceScenarioSynth  # noqa: E402
from gps_sdr.runtime.evaluator import Evaluator  # noqa: E402
from gps_sdr.runtime.serving import StreamServer  # noqa: E402

cfg = ReceiverConfig().replace(download_windows_in_flight=args.wif,
                               chunks_per_download=16,
                               defer_subframe_poll=True,
                               epoch_per_window=True)
t_sv = cfg.no_sec
n_chunks = int(round(args.sec / (t_sv * cfg.block_sec)))
scn = make_scenario(cfg, n_sats=10, seed=5, duration_sec=args.sec + 12.0)
dsv = DeviceScenarioSynth(scn, noise_std=0.5)
parts = [dsv.chunk_planar(ci * t_sv, t_sv) for ci in range(n_chunks)]
buf = jnp.concatenate(parts)
for pt in parts:
    pt.delete()


@functools.partial(jax.jit, static_argnums=2)
def _slice(b, first, n):
    return jax.lax.dynamic_slice_in_dim(b, first, n)


def provider(first, n):
    return _slice(buf, jnp.int32(first), n)


srv = StreamServer(cfg, args.streams)
evs = [Evaluator(cfg) for _ in range(args.streams)]
w = cfg.chunks_per_download

it = srv.run(provider, n_chunks)
for _ in range(args.streams):          # warm: the first window
    s, epoch = next(it)
    evs[s].process(epoch)

from gps_sdr.runtime.evaluator import process_many  # noqa: E402

prof = cProfile.Profile()
t0 = time.perf_counter()
prof.enable()
done = 0
pend = []
for s, epoch in it:
    pend.append((evs[s], epoch))
    if len(pend) == args.streams:      # cross-stream batched window
        process_many(pend)
        pend = []
    done += 1
process_many(pend)
prof.disable()
wall = time.perf_counter() - t0
sig = (n_chunks - min(w, n_chunks - 1)) * t_sv * cfg.block_sec
print(f"steady-state: {done} epochs, {args.streams} streams, "
      f"{sig:.1f}s signal in {wall:.2f}s = aggregate "
      f"{args.streams * sig / wall:.1f}x realtime")
fixes = sum(len(e.positions) for e in evs)
print(f"fixes: {fixes}")
st = pstats.Stats(prof)
st.sort_stats("cumulative").print_stats(25)
