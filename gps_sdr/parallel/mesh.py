"""Device-mesh construction for the receiver.

Two mesh axes (SURVEY.md section 7, step 6):

  * ``time`` — overlap-save time shards of a long IQ stream (the
    reference processes blocks strictly sequentially, gpsrecv.py:466;
    carry state crosses shard boundaries via ppermute stitching,
    parallel/tracking.py).
  * ``ch``   — channel (satellite) parallelism, replacing the
    reference's one-process-per-satellite pool (gpsrecv.py:300-360).

Acquisition reuses the same axes as (Doppler bins x PRNs).
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh

TIME_AXIS = "time"
CH_AXIS = "ch"
STREAM_AXIS = "stream"


def make_stream_mesh(n_devices: int | None = None) -> Mesh:
    """One-axis ``stream`` mesh for serving scale-out: S independent
    receiver streams are embarrassingly parallel (no cross-stream
    state), so sharding the leading stream axis of track_streams over
    devices is collective-free and scales near-linearly — the
    production multi-chip serving shape (one pod front-ending a fleet
    of antennas)."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    return Mesh(np.asarray(devs[:n_devices]), (STREAM_AXIS,))


def factor2(n: int) -> tuple[int, int]:
    """Split n into (a, b), a*b == n, as square as possible with b >= a."""
    a = int(math.isqrt(n))
    while n % a:
        a -= 1
    return a, n // a


def make_mesh(n_devices: int | None = None,
              time_shards: int | None = None) -> Mesh:
    """Build a (time, ch) mesh over the first n_devices devices.

    If time_shards is given, the ch axis gets n_devices // time_shards;
    otherwise the factorization is as square as possible.
    """
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    devs = devs[:n_devices]
    if time_shards is None:
        time_shards, ch = factor2(n_devices)
    else:
        if n_devices % time_shards:
            raise ValueError(f"{n_devices} devices not divisible into "
                             f"{time_shards} time shards")
        ch = n_devices // time_shards
    arr = np.asarray(devs).reshape(time_shards, ch)
    return Mesh(arr, (TIME_AXIS, CH_AXIS))


def make_multihost_mesh(coordinator_address: str | None = None,
                        num_processes: int | None = None,
                        process_id: int | None = None,
                        time_shards: int | None = None) -> Mesh:
    """(time, ch) mesh spanning every device of a multi-host deployment.

    Initializes jax.distributed when coordinator parameters are given
    (nothing detects a cluster on its own: pass coordinator_address,
    num_processes and process_id), then builds the global mesh —
    shard_map programs in parallel/ work unchanged: XLA routes the
    ppermute carry exchanges and acquisition all_gathers between the
    devices (NCCL on GPUs).  Without coordinator parameters this is
    make_mesh over the local devices.
    """
    if coordinator_address is not None or num_processes is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
    return make_mesh(len(jax.devices()), time_shards=time_shards)
