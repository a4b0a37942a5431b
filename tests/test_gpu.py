"""Tests that need a GPU (pytest marker `gpu`); each skips without one.

chip_smoke.py phase (f) runs them on the card; by hand:
    python -m pytest -m gpu tests/test_gpu.py
(conftest.py defaults JAX_PLATFORMS to cpu, so set JAX_PLATFORMS=cuda
when running them directly.)
"""

import numpy as np
import pytest


@pytest.fixture
def gpu():
    import jax

    d = jax.devices()[0]
    if d.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {d.platform}")
    return d


@pytest.mark.gpu
def test_trace_reads_gpu_lanes(gpu, tmp_path):
    """The trace reduction finds the card's lanes and its kernels."""
    import jax
    import jax.numpy as jnp

    from gps_sdr.utils.profiling import (device_time_from_trace,
                                         op_breakdown_from_trace, trace)

    f = jax.jit(lambda x: jnp.abs(jnp.fft.fft(x, axis=-1)).sum(-1))
    x = jnp.ones((64, 2048), jnp.complex64)
    jax.block_until_ready(f(x))
    with trace(str(tmp_path)):
        for _ in range(3):
            jax.block_until_ready(f(x))
    dev = device_time_from_trace(str(tmp_path))
    assert dev["device"].startswith("/device:GPU")
    assert dev["n_ops"] >= 3 and 0 < dev["busy_s"] <= dev["span_s"]
    assert op_breakdown_from_trace(str(tmp_path))


@pytest.mark.gpu
def test_fir_decimator_runs_at_full_precision(gpu):
    """The front end's strided FIR convolution is pinned to HIGHEST
    precision: against float64 numpy it agrees to ~1e-6 relative, where
    a TF32 convolution would be off by ~1e-3."""
    import jax.numpy as jnp

    from gps_sdr.ops.frontend import _fir_decimate, decimation_taps

    factor = 4
    taps = decimation_taps(factor)
    x = np.random.default_rng(0).standard_normal((2, 1 << 16)) \
        .astype(np.float32)
    got = np.asarray(_fir_decimate(jnp.asarray(x), jnp.asarray(taps),
                                   factor))
    ref = np.stack([np.convolve(r.astype(np.float64),
                                taps.astype(np.float64),
                                mode="valid")[::factor] for r in x])
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5


@pytest.mark.gpu
def test_cufft_matches_numpy_at_wideband_length(gpu):
    """ops/dft on the card at the 16 MS/s code length against numpy's
    float64 FFT (float32 butterflies: ~log2(n) * 6e-8 relative)."""
    import jax.numpy as jnp

    from gps_sdr.ops.dft import dft, idft

    rng = np.random.default_rng(1)
    x = (rng.standard_normal((32, 16384))
         + 1j * rng.standard_normal((32, 16384))).astype(np.complex64)
    for fn, ref in ((dft, np.fft.fft), (idft, np.fft.ifft)):
        got = np.asarray(fn(jnp.asarray(x)))
        r = ref(x.astype(np.complex128), axis=-1)
        assert np.abs(got - r).max() / np.abs(r).max() < 2e-5
