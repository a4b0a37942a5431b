"""Forward/inverse DFT along the last axis, complex64 in and out.

The correlation pipeline needs DFTs of length code_samples (2048, or
16384 for the 16 MS/s front end).  Every backend runs jnp.fft: cuFFT on
the GPU, pocketfft on the CPU.  A matrix-multiply DFT was measured
against cuFFT on an H100 and lost at every shape the receiver uses
(PERF.md, Findings), so there is one path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def dft(x: Array) -> Array:
    """DFT along the last axis (complex64 in/out)."""
    return jnp.fft.fft(x, axis=-1).astype(jnp.complex64)


def idft(x: Array) -> Array:
    """Inverse DFT along the last axis (complex64 in/out)."""
    return jnp.fft.ifft(x, axis=-1).astype(jnp.complex64)
