"""Vectorized edge detector vs the sequential reference chain.

_edge_scan (cummax prefix form) must match _edge_scan_seq (the
reference's decodeData loop semantics) slot-for-slot and
state-for-state on adversarial inputs: random signs, near-threshold
amplitudes, zero means, unlocked blocks, fresh chains (sign0 == 0),
empty masks, and multi-block chaining."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gps_sdr.ops.tracking import _edge_scan, _edge_scan_seq

SL = 33


def _case(rng, force=None):
    n_valid = force["n_valid"] if force and "n_valid" in force \
        else int(rng.integers(0, SL + 1))
    re = rng.choice([-1.0, 1.0], SL) * rng.uniform(0.2, 2.0, SL)
    # sprinkle exact zeros and tiny values around the gate threshold
    z = rng.random(SL) < 0.15
    re[z] = 0.0
    means = jnp.asarray(re + 0.3j * rng.standard_normal(SL), jnp.complex64)
    starts = jnp.asarray(rng.integers(-2048, 65536, SL), jnp.int32)
    mask = jnp.asarray(np.arange(SL) < n_valid)
    locked = jnp.asarray(bool(force["locked"]) if force and "locked"
                         in force else bool(rng.integers(0, 2)))
    amp = jnp.float32(rng.uniform(0.0, 1.5))
    sign0 = jnp.asarray(
        force["sign0"] if force and "sign0" in force
        else int(rng.choice([-1, 0, 1])), jnp.int8)
    prev_sign = jnp.asarray(
        0 if int(sign0) == 0 else int(rng.choice([-1, 1])), jnp.int8)
    prev_signal = jnp.float32(rng.choice([-1.0, 0.0, 1.0])
                              * rng.uniform(0.0, 2.0))
    ms_time = jnp.asarray(int(rng.integers(0, 50000)), jnp.int32)
    return (means, starts, mask, locked, amp, sign0, prev_sign,
            prev_signal, ms_time)


def _assert_same(args):
    ref = _edge_scan_seq(*args)
    got = _edge_scan(*args)
    names = ("sign0", "prev_sign", "prev_signal", "ms_time",
             "ems", "est", "evalid")
    for n, a, b in zip(names, ref, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=n)


@pytest.mark.parametrize("seed", range(8))
def test_random_cases(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        _assert_same(_case(rng))


def test_fresh_chain_and_unlocked():
    rng = np.random.default_rng(99)
    for force in ({"sign0": 0}, {"locked": False}, {"n_valid": 0},
                  {"sign0": 0, "n_valid": 1}, {"n_valid": SL}):
        for _ in range(20):
            _assert_same(_case(rng, force))


def test_chained_blocks_match():
    """State threads identically across a multi-block sequence."""
    rng = np.random.default_rng(7)
    args = _case(rng, {"sign0": 0, "locked": True, "n_valid": SL})
    st_ref = args[5:]
    st_got = args[5:]
    for b in range(12):
        blk = _case(rng, {"locked": True,
                          "n_valid": int(rng.integers(28, SL + 1))})
        a_ref = blk[:5] + st_ref
        a_got = blk[:5] + st_got
        ref = _edge_scan_seq(*a_ref)
        got = _edge_scan(*a_got)
        for n, a, g in zip(("sign0", "prev_sign", "prev_signal",
                            "ms_time", "ems", "est", "evalid"),
                           ref, got):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(g),
                                          err_msg=f"block {b}: {n}")
        st_ref = ref[:4]
        st_got = got[:4]


def test_vmapped_over_channels():
    rng = np.random.default_rng(3)
    cases = [_case(rng) for _ in range(6)]
    batched = tuple(jnp.stack([c[i] for c in cases])
                    for i in range(9))
    vref = jax.vmap(_edge_scan_seq)(*batched)
    vgot = jax.vmap(_edge_scan)(*batched)
    for a, b in zip(vref, vgot):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
