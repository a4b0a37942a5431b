"""Profiling and throughput observability.

The reference's only performance surface is a wall-clock print and a
skipped-block counter in the GUI (SURVEY.md section 5: gpsrecv.py:554,
gpsui.py:409-410).  Here throughput is first-class: a RateMeter tracks
samples/s and the real-time factor over a sliding window, and `trace()`
wraps jax.profiler for device timeline captures viewable in
TensorBoard/Perfetto.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from dataclasses import dataclass, field


@dataclass
class RateMeter:
    """Sliding-window samples/s + real-time-factor meter."""

    sample_rate: float                 # stream samples per stream second
    window_sec: float = 10.0
    _events: deque = field(default_factory=deque)   # (wall_t, n_samples)
    total_samples: int = 0
    t0: float | None = None

    def add(self, n_samples: int) -> None:
        now = time.perf_counter()
        if self.t0 is None:
            self.t0 = now
        self.total_samples += n_samples
        self._events.append((now, n_samples))
        cutoff = now - self.window_sec
        while self._events and self._events[0][0] < cutoff:
            self._events.popleft()

    @property
    def samples_per_sec(self) -> float:
        if len(self._events) < 2:
            return 0.0
        span = self._events[-1][0] - self._events[0][0]
        n = sum(e[1] for e in self._events) - self._events[0][1]
        return n / span if span > 0 else 0.0

    @property
    def realtime_factor(self) -> float:
        """Processing speed relative to the stream's own rate."""
        return self.samples_per_sec / self.sample_rate

    def summary(self) -> dict:
        wall = (time.perf_counter() - self.t0) if self.t0 else 0.0
        return {
            "total_samples": self.total_samples,
            "wall_sec": round(wall, 3),
            "mean_rtf": round(
                self.total_samples / self.sample_rate / wall, 2)
            if wall > 0 else 0.0,
            "window_rtf": round(self.realtime_factor, 2),
            "window_msamples_per_sec": round(
                self.samples_per_sec / 1e6, 2),
        }


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device/host profile into `log_dir` (open with
    TensorBoard's profile plugin or Perfetto; device_time_from_trace
    reduces it)."""
    import jax

    jax.profiler.start_trace(log_dir, create_perfetto_trace=True)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def card_label() -> str:
    """The first card's `name, power limit` as nvidia-smi reports them
    (a card may run below its maximum power, and slower under load, so
    every device number is recorded beside this).  Fails without one."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


REPO_CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its path.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and it
    is left alone; otherwise the cache goes to the fixed <repo>/.jax_cache
    (a fixed path, so repeat runs hit).  Safe to call multiple times;
    tests/conftest.py calls it for pytest."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = REPO_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def _device_trace(log_dir: str) -> tuple[list, dict]:
    """Events of the newest Perfetto trace under `log_dir` and its
    device processes {pid: name}.  Device processes are named
    "/device:GPU:<n>" (each CUDA stream is one lane of it); the CPU
    backend has only "/host:CPU", so a CPU trace has no device lane and
    is refused rather than read as one."""
    import glob
    import gzip
    import json as _json

    paths = sorted(glob.glob(os.path.join(
        log_dir, "**", "perfetto_trace.json.gz"), recursive=True),
        key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no trace under {log_dir}")
    with gzip.open(paths[-1], "rt") as f:
        doc = _json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    devices = {ev["pid"]: ev["args"]["name"] for ev in events
               if ev.get("ph") == "M" and ev.get("name") == "process_name"
               and ev.get("args", {}).get("name", "").startswith(
                   "/device:")}
    if not devices:
        raise RuntimeError(f"no device lane in the trace under {log_dir}: "
                           "nothing ran on an accelerator")
    return events, devices


def _union_us(iv: list) -> float:
    iv.sort()
    tot, cur0, cur1 = 0.0, None, None
    for a, b in iv:
        if cur1 is None or a > cur1:
            if cur1 is not None:
                tot += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    if cur1 is not None:
        tot += cur1 - cur0
    return tot


def device_time_from_trace(log_dir: str) -> dict:
    """Device-side timing from the newest jax.profiler trace under
    `log_dir` (see trace()), for the busiest device:

      {"busy_s":  union of its operation intervals over all its lanes
                  (streams), i.e. the time it ran anything,
       "span_s":  last operation end - first start (busy + idle),
       "n_ops":   operations (kernels and copies) it ran,
       "n_lanes": its lanes, "device": its process name}

    Raises when the trace holds no device lane."""
    events, devices = _device_trace(log_dir)
    per_dev: dict = {}
    for ev in events:
        if (ev.get("ph") != "X" or ev.get("pid") not in devices
                or ev.get("dur") is None):
            continue
        d = per_dev.setdefault(ev["pid"], {"iv": [], "lanes": set()})
        d["iv"].append((ev["ts"], ev["ts"] + ev["dur"]))
        d["lanes"].add(ev.get("tid"))
    if not per_dev:
        raise RuntimeError(f"device lanes under {log_dir} hold no "
                           "operations")
    stats = {pid: (_union_us(list(d["iv"])), d) for pid, d in
             per_dev.items()}
    pid = max(stats, key=lambda k: stats[k][0])
    busy, d = stats[pid]
    t0 = min(a for a, _ in d["iv"])
    t1 = max(b for _, b in d["iv"])
    return {"busy_s": busy / 1e6, "span_s": (t1 - t0) / 1e6,
            "n_ops": len(d["iv"]), "n_lanes": len(d["lanes"]),
            "device": devices[pid]}


def op_breakdown_from_trace(log_dir: str, top: int = 20) -> list:
    """Per-operation device-time totals of the newest trace under
    `log_dir`, over every device lane: [(op_name, total_s, count), ...]
    sorted by total time.  Names are XLA fusion or library kernel
    names.  Raises when the trace holds no device lane."""
    from collections import defaultdict

    events, devices = _device_trace(log_dir)
    ops = defaultdict(lambda: [0.0, 0])
    for ev in events:
        if (ev.get("ph") == "X" and ev.get("pid") in devices
                and ev.get("dur") is not None):
            o = ops[ev.get("name", "?")]
            o[0] += ev["dur"] / 1e6
            o[1] += 1
    out = sorted(((k, v[0], v[1]) for k, v in ops.items()),
                 key=lambda x: -x[1])
    return out[:top]
