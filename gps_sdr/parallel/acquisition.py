"""Sharded cold-start acquisition: (Doppler bins x PRNs) over the mesh.

The single-chip kernel (ops/acquisition.py) already evaluates the whole
grid in one program; here the grid itself is partitioned — Doppler bins
over the ``time`` axis, PRN rows over the ``ch`` axis — so a stress-size
grid (32 PRN x +-10 kHz, BASELINE.md) scales across chips.  Every bin's
normalized-peak statistic is computed from its own correlation curve,
so sharding the grid is exact; the only collective is an all_gather of
the tiny per-(shard, PRN) best records over the Doppler axis
(SURVEY.md P6: correlator partial sums ride the device interconnect).

Reference analogue: sweepAllSats throttled at 10 Doppler steps per 32 ms
block on CPU (src/gpsrecv.py:241-274, src/gpsglob.py:41-44).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gps_sdr.config import ReceiverConfig
from gps_sdr.ops import dsp
from gps_sdr.ops.acquisition import AcqResult, acquire_impl
from gps_sdr.parallel.mesh import CH_AXIS, TIME_AXIS


def _pad_to(x: np.ndarray, mult: int, axis: int = 0) -> np.ndarray:
    n = x.shape[axis]
    rem = (-n) % mult
    if rem == 0:
        return x
    take = np.take(x, np.zeros(rem, np.int64), axis=axis)
    return np.concatenate([x, take], axis=axis)


def _acq_shard(cfg: ReceiverConfig, block, dopplers_local, ffts_local):
    """Per-device grid tile + reduction over the Doppler mesh axis."""
    res = acquire_impl(cfg, block, dopplers_local, ffts_local)
    # [S, P_local] per field; pick the Doppler shard with the best peak
    gathered = jax.tree.map(
        lambda x: jax.lax.all_gather(x, TIME_AXIS), res)
    best = jnp.argmax(gathered.norm_max, axis=0)
    pick = lambda x: jnp.take_along_axis(x, best[None, :], axis=0)[0]
    return AcqResult(*(pick(f) for f in gathered))


@functools.partial(jax.jit, static_argnums=(0, 1))
def _acquire_sharded_jit(cfg: ReceiverConfig, mesh: Mesh, block,
                         dopplers, code_ffts) -> AcqResult:
    fn = jax.shard_map(
        functools.partial(_acq_shard, cfg), mesh=mesh,
        in_specs=(P(), P(TIME_AXIS), P(CH_AXIS)),
        out_specs=AcqResult(*([P(CH_AXIS)] * len(AcqResult._fields))),
        check_vma=False)
    return fn(block, dopplers, code_ffts)


def acquire_sharded(cfg: ReceiverConfig, mesh: Mesh, block,
                    dopplers: np.ndarray,
                    code_ffts: np.ndarray) -> AcqResult:
    """Full-grid acquisition sharded over `mesh`; host-friendly wrapper.

    block: complex64[>= sweep_corr_avg*code_samples] or f32[..., 2];
    dopplers: f32[D]; code_ffts: complex64[P, cs] or f32[P, cs, 2].
    Pads D / P up to mesh-axis multiples (padded PRN rows repeat row 0
    and are dropped from the result).
    """
    t_size = mesh.shape[TIME_AXIS]
    c_size = mesh.shape[CH_AXIS]
    n_prn = code_ffts.shape[0]
    dop = _pad_to(np.asarray(dopplers, np.float32), t_size)
    ffts = _pad_to(np.asarray(code_ffts), c_size)
    if ffts.dtype != np.float32:
        ffts = np.stack([ffts.real.astype(np.float32),
                         ffts.imag.astype(np.float32)], axis=-1)
    dev_dop = jax.device_put(
        jnp.asarray(dop), NamedSharding(mesh, P(TIME_AXIS)))
    dev_ffts = jax.device_put(
        jnp.asarray(ffts), NamedSharding(mesh, P(CH_AXIS)))
    res = _acquire_sharded_jit(cfg, mesh, jnp.asarray(block),
                               dev_dop, dev_ffts)
    return AcqResult(*(np.asarray(f)[:n_prn] for f in res))
