"""ChannelOut packed-transfer round trip (ops/tracking.py pack_outs).

The host<->device boundary carries f32 only, so every ChannelOut crosses
as one packed f32 buffer.  f32 is integer-exact only below 2^24;
edge_ms counts ms since lock and exceeds that after ~4.66 h of
continuous lock, so it crosses as hi/lo planes."""

import numpy as np
import jax.numpy as jnp

from gps_sdr.ops.tracking import ChannelOut, pack_outs, unpack_outs


def _outs(shape_scalar, shape_edge, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda: jnp.asarray(rng.standard_normal(shape_scalar),
                            jnp.float32)
    i = lambda hi: jnp.asarray(rng.integers(0, hi, shape_scalar),
                               jnp.int32)
    b = lambda: jnp.asarray(rng.integers(0, 2, shape_scalar).astype(bool))
    return ChannelOut(
        code_phase=f(), delay=i(2048), norm_max=f(), amplitude=f(),
        corr_q=f(), corr_l=f(), freq=f(), locked=b(), erased=b(),
        sweep_request=b(),
        sign0=jnp.asarray(rng.integers(-1, 2, shape_scalar), jnp.int8),
        # ms_time far beyond 2^24 (>4.66 h of lock) must survive exactly
        edge_ms=jnp.asarray(rng.integers(0, 40_000_000, shape_edge),
                            jnp.int32),
        edge_local=jnp.asarray(rng.integers(-2048, 65536, shape_edge),
                               jnp.int32),
        edge_valid=jnp.asarray(
            rng.integers(0, 2, shape_edge).astype(bool)))


def _check(outs):
    n_edge = outs.edge_ms.shape[-1]
    back = unpack_outs(np.asarray(pack_outs(outs)), n_edge)
    for name in ChannelOut._fields:
        a, g = np.asarray(getattr(outs, name)), getattr(back, name)
        np.testing.assert_array_equal(a, g, err_msg=name)


def test_roundtrip_exact_beyond_2_24():
    _check(_outs((7, 3), (7, 3, 33)))


def test_roundtrip_stream_stacked():
    # track_streams outputs carry a leading stream axis
    _check(_outs((2, 5, 3), (2, 5, 3, 33), seed=1))
