"""Bounded block buffer with drop-oldest overflow and skip accounting.

Mirrors the reference's producer/consumer deque (src/gpsrecv.py:45-104):
on overflow the whole buffer is cleared and the number of dropped blocks
is credited to a skip counter that travels with the next pulled block,
so downstream tracking can detect the stream gap and reset demodulation
state (the reference's erasePrevData path, SURVEY.md section 5 failure
semantics (a)).
"""

from __future__ import annotations

import threading
from collections import deque

import numpy as np


class BlockBuffer:
    def __init__(self, max_blocks: int = 16):
        self.max_blocks = max_blocks
        self._dq: deque = deque()
        self._skipped = 0
        self._lock = threading.Lock()

    def push(self, block: np.ndarray) -> None:
        with self._lock:
            if len(self._dq) >= self.max_blocks:
                self._skipped += len(self._dq)
                self._dq.clear()
            self._dq.append(block)

    def pull(self):
        """Returns (block | None, n_skipped_blocks_before_it)."""
        with self._lock:
            if not self._dq:
                return None, 0
            block = self._dq.popleft()
            skipped, self._skipped = self._skipped, 0
            return block, skipped

    def __len__(self) -> int:
        return len(self._dq)

    @property
    def skipped(self) -> int:
        return self._skipped


def make_buffer(max_blocks: int = 16, block_samples: int | None = None):
    """Best buffer available: the native lock-free SPSC ring
    (csrc/ingest.cpp, GIL-free) when built and a block size is known,
    else the Python deque."""
    if block_samples is not None:
        try:
            from gps_sdr.runtime._native import NativeRing

            ring = NativeRing(max_blocks, block_samples)

            class _RingAdapter:
                max_blocks_ = max_blocks

                def push(self, block):
                    ring.push(block)

                def pull(self):
                    out = ring.pop()
                    if out is None:
                        return None, 0
                    return out

                def __len__(self):
                    return len(ring)

            return _RingAdapter()
        except Exception:
            pass
    return BlockBuffer(max_blocks)
