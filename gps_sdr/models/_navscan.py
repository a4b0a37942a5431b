"""ctypes binding for the native subframe scanner (csrc/navscan.cpp).

Build with `make -C csrc` (produces models/libgsdrnav.so).  The scanner
replaces poll_subframes' Python walk (preamble correlation + parity
check/unscramble); field extraction stays in Python so the declarative
IS-GPS-200 tables in navmsg.py remain the single source of truth — the
parity taps and the ID span are passed INTO the native code from those
same tables.  A numpy fallback (navmsg.py) keeps the framework fully
functional without the native build.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "libgsdrnav.so")


from gps_sdr.nativecore import load_native_lib  # noqa: E402

_lib = load_native_lib(_LIB_PATH, "GSDR_NAVSCAN_BUILD")

_i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_lib.gsdr_navscan.argtypes = [
    _i8p, ctypes.c_int64, _i8p, _i8p,
    ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ctypes.c_int64, _i64p, _i8p, _i64p]
_lib.gsdr_navscan.restype = ctypes.c_int64


def navscan(bits: np.ndarray, taps: np.ndarray, seed29: np.ndarray,
            id_span: tuple[int, int, int]
            ) -> tuple[np.ndarray, np.ndarray, int]:
    """Scan a ±1 logical-bit buffer for parity-valid subframes.

    Returns (starts int64[k], words int8[k, 300] source-domain 0/1
    bits, final_start) with the exact walk semantics of the Python
    scanner (advance 300 on success, next preamble candidate on
    failure; final_start is the buffer-trim position).
    """
    bits = np.ascontiguousarray(bits, np.int8)
    n = bits.shape[0]
    cap = max(1, n // 300 + 1)
    starts = np.zeros(cap, np.int64)
    words = np.zeros(cap * 300, np.int8)
    fin = np.zeros(1, np.int64)
    k = _lib.gsdr_navscan(
        bits, n, np.ascontiguousarray(taps, np.int8),
        np.ascontiguousarray(seed29, np.int8),
        id_span[0], id_span[1], id_span[2], cap, starts, words, fin)
    return starts[:k], words[:k * 300].reshape(k, 300), int(fin[0])
