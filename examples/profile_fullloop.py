"""Profile the HOST side of the full receiver loop (run_device ->
unpack -> decoders -> evaluator).  Device work runs on the backend JAX
selects (JAX_PLATFORMS=cpu for a CPU run); only the host functions'
tottime matters — they are platform-independent and bound
full_loop_rtf whenever device tracking is far faster than realtime.

Usage: python examples/profile_fullloop.py [--sec 24]
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
args = p.parse_args()

import jax  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gps_sdr.config import ReceiverConfig  # noqa: E402
from gps_sdr.models.scenario import make_scenario  # noqa: E402
from gps_sdr.models.scenario_jax import DeviceScenarioSynth  # noqa: E402
from gps_sdr.runtime.evaluator import Evaluator  # noqa: E402
from gps_sdr.runtime.receiver import Receiver  # noqa: E402

cfg = ReceiverConfig()
cfg = cfg.replace(download_windows_in_flight=2)
t_fl = cfg.no_sec
n_chunks = int(round(args.sec / (t_fl * cfg.block_sec)))
scn = make_scenario(cfg, n_sats=10, seed=3, duration_sec=args.sec + 12.0)
devsyn = DeviceScenarioSynth(scn, noise_std=0.5)
parts = [devsyn.chunk_planar(ci * t_fl, t_fl) for ci in range(n_chunks)]
buf = jnp.concatenate(parts)
for pt in parts:
    pt.delete()


@functools.partial(jax.jit, static_argnums=2)
def _slice(b, first, n):
    return jax.lax.dynamic_slice_in_dim(b, first, n)


def provider(first, n):
    return _slice(buf, jnp.int32(first), n)


rec = Receiver(cfg)
ev = Evaluator(cfg)

# warm: first window (compiles + acquisition)
it = rec.run_device(provider, n_chunks)
warm = min(cfg.chunks_per_download, n_chunks - 1)
for _ in range(warm):
    ev.process(next(it))

prof = cProfile.Profile()
t0 = time.perf_counter()
prof.enable()
done = 0
for epoch in it:
    ev.process(epoch)
    done += 1
prof.disable()
wall = time.perf_counter() - t0
sig = done * t_fl * cfg.block_sec
print(f"steady-state: {done} chunks, {sig:.1f}s signal in {wall:.2f}s "
      f"= {sig / wall:.1f}x realtime  ({1e3 * wall / done:.1f} ms/chunk)")
st = pstats.Stats(prof)
st.sort_stats("cumulative").print_stats(30)
