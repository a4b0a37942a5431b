"""IQ sample sources: file replay, synthetic streaming, live SDR.

Replaces the reference's async stream producers (src/gpsrecv.py:109-186)
and the recorder utility (src/gpsbin.py).  The on-disk format is the
reference's: interleaved 8-bit I/Q packed as uint16 little-endian words
with value = 256*Q + I, normalized to complex64 via v/127.5 - (1+1j)
(gpsrecv.py:168-172), so recorded captures replay bit-identically.

The uint16 -> complex64 unpack is the only byte-crunching on the host
data path; a C++ SIMD-friendly implementation (csrc/ingest.cpp) is used
when built, with a numpy fallback.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from gps_sdr.config import ReceiverConfig

try:  # optional native unpack (csrc/ingest.cpp via ctypes)
    from gps_sdr.runtime._native import unpack_iq as _native_unpack
except Exception:  # pragma: no cover - fallback path
    _native_unpack = None


def unpack_iq(words: np.ndarray) -> np.ndarray:
    """uint16 packed IQ -> normalized complex64.

    Per-component v/127.5 - 1 evaluated in double and rounded once to
    f32 (identical to the native LUT in csrc/ingest.cpp; the reference
    computes the same value in float64, gpsrecv.py:170-172)."""
    if _native_unpack is not None:
        return _native_unpack(words)
    im, re = np.divmod(words, 256)
    return (np.float32(re / 127.5 - 1.0)
            + 1j * np.float32(im / 127.5 - 1.0)).astype(np.complex64)


def pack_iq(samples: np.ndarray) -> np.ndarray:
    """complex64 in [-1-1j, 1+1j) -> packed uint16 (recording format)."""
    re = np.clip(np.round((samples.real + 1.0) * 127.5), 0, 255)
    im = np.clip(np.round((samples.imag + 1.0) * 127.5), 0, 255)
    return (im.astype(np.uint16) * 256 + re.astype(np.uint16))


def replay_blocks(path: str, cfg: ReceiverConfig,
                  start_stream: int = 0,
                  max_blocks: int | None = None) -> Iterator[np.ndarray]:
    """Stream NGPS-sample complex64 blocks from a recorded capture
    (streamData, gpsrecv.py:153-186; START_STREAM skip supported)."""
    n = 0
    with open(path, "rb") as f:
        if start_stream:
            f.seek(2 * cfg.ngps * start_stream, os.SEEK_SET)
        while max_blocks is None or n < max_blocks:
            words = np.fromfile(f, dtype=np.uint16, count=cfg.ngps)
            if words.size != cfg.ngps:
                return  # EOF
            yield unpack_iq(words)
            n += 1


def replay_decimated(path: str, cfg: ReceiverConfig, input_rate: float,
                     f_if: float = 0.0, fmt: str = "iq8",
                     start_stream: int = 0,
                     max_blocks: int | None = None
                     ) -> Iterator[np.ndarray]:
    """Replay a HIGHER-RATE capture through the digital front end
    (ops/frontend.py) into standard ngps-sample blocks.

    input_rate must be an integer multiple of cfg.sample_rate; fmt is
    "iq8" (the reference's packed uint16 IQ) or "real16" (int16 real
    samples, e.g. a real-IF front end — give f_if).  The reference can
    only ingest its one native rate/format (gpsrecv.py:153-186).
    start_stream/max_blocks apply to the decimated OUTPUT blocks."""
    from gps_sdr.ops.frontend import frontend_blocks

    factor = round(input_rate / cfg.sample_rate)
    if abs(input_rate - factor * cfg.sample_rate) > 1e-6 or factor < 1:
        raise ValueError(
            f"input_rate {input_rate} is not an integer multiple of "
            f"{cfg.sample_rate}")
    chunk = factor * cfg.ngps

    def raw():
        with open(path, "rb") as f:
            while True:
                if fmt == "iq8":
                    words = np.fromfile(f, dtype=np.uint16, count=chunk)
                    if words.size == 0:
                        return
                    yield unpack_iq(words)
                elif fmt == "real16":
                    raw16 = np.fromfile(f, dtype=np.int16, count=chunk)
                    if raw16.size == 0:
                        return
                    yield raw16.astype(np.float32) / 32768.0
                else:
                    raise ValueError(f"unknown capture format {fmt!r}")

    gen = frontend_blocks(raw(), cfg, factor, f_if=f_if,
                          fs_in=input_rate)
    n = 0
    for blk in gen:
        if start_stream > 0:
            start_stream -= 1
            continue
        if max_blocks is not None and n >= max_blocks:
            return
        yield blk
        n += 1


def record_blocks(path: str, blocks, append: bool = False) -> int:
    """Write complex64 blocks in the capture format (gpsbin.py's role).
    Returns the number of blocks written."""
    mode = "ab" if append else "wb"
    n = 0
    with open(path, mode) as f:
        for b in blocks:
            pack_iq(np.asarray(b)).tofile(f)
            n += 1
    return n


def synthetic_blocks(cfg: ReceiverConfig, sats, n_blocks: int,
                     noise_std: float = 0.7, seed: int = 0,
                     chunk_blocks: int | None = None) -> Iterator[np.ndarray]:
    """Stream synthetic blocks (generated chunkwise to bound memory)."""
    from gps_sdr.models.simulator import synth_stream_chunk

    step = chunk_blocks or cfg.no_sec
    done = 0
    while done < n_blocks:
        k = min(step, n_blocks - done)
        chunk = synth_stream_chunk(cfg, sats, first_block=done, n_blocks=k,
                                   noise_std=noise_std, seed=seed)
        for i in range(k):
            yield chunk[i]
        done += k


def live_blocks(cfg: ReceiverConfig, gain_db: float = 50.0,
                bias_tee: bool = True) -> Iterator[np.ndarray]:
    """Live RTL-SDR source (streamLive, gpsrecv.py:109-148).

    Requires the optional pyrtlsdr package + hardware; import is gated so
    the framework runs without it.
    """
    try:
        from rtlsdr import RtlSdr  # type: ignore
    except ImportError as e:  # pragma: no cover - hardware path
        raise RuntimeError(
            "live capture requires the optional 'pyrtlsdr' package and an "
            "RTL-SDR dongle; use replay_blocks/synthetic_blocks instead"
        ) from e
    sdr = RtlSdr()  # pragma: no cover - hardware path
    try:
        sdr.set_bias_tee(bias_tee)
        sdr.sample_rate = cfg.sample_rate
        if cfg.sdr_freq_corr_ppm:
            sdr.freq_correction = cfg.sdr_freq_corr_ppm
        sdr.center_freq = 1575.42e6
        sdr.gain = gain_db
        while True:
            samples = sdr.read_samples(cfg.ngps)
            yield np.asarray(samples, dtype=np.complex64)
    finally:
        sdr.close()
