"""C/A (coarse/acquisition) Gold-code generation and resampling.

The reference vendors a precomputed 37x1023 table (src/cacodes.py).  Here
the codes are *generated* from the IS-GPS-200 G1/G2 LFSR definition and
unit-tested against the published first-10-chip octals, then resampled
with the reference's chip-doubling + linear interpolation semantics
(src/gpslib.py:62-87) so correlation results are bit-comparable.

All tables are built once at f32/c64 with static shapes:
    ca_table(cfg)      -> float32[38, code_samples]   (index = PRN, 0 unused)
    ca_fft_table(cfg)  -> complex64[38, code_samples]
"""

from __future__ import annotations

import functools

import numpy as np

from gps_sdr.config import CA_CHIPS, DSP_FLOAT, ReceiverConfig

N_PRN = 37  # PRNs 1..37 defined by IS-GPS-200 (34 and 37 share taps)

# G2 phase-select taps per PRN (IS-GPS-200 table 3-I), 1-indexed stages.
G2_TAPS: dict[int, tuple[int, int]] = {
    1: (2, 6), 2: (3, 7), 3: (4, 8), 4: (5, 9), 5: (1, 9),
    6: (2, 10), 7: (1, 8), 8: (2, 9), 9: (3, 10), 10: (2, 3),
    11: (3, 4), 12: (5, 6), 13: (6, 7), 14: (7, 8), 15: (8, 9),
    16: (9, 10), 17: (1, 4), 18: (2, 5), 19: (3, 6), 20: (4, 7),
    21: (5, 8), 22: (6, 9), 23: (1, 3), 24: (4, 6), 25: (5, 7),
    26: (6, 8), 27: (7, 9), 28: (8, 10), 29: (1, 6), 30: (2, 7),
    31: (3, 8), 32: (4, 9), 33: (5, 10), 34: (4, 10), 35: (1, 7),
    36: (2, 8), 37: (4, 10),
}


@functools.lru_cache(maxsize=None)
def ca_chips(prn: int) -> np.ndarray:
    """1023 C/A chips for one PRN as +/-1 (int8); chip value 1 -> +1.

    G1: x^10 + x^3 + 1 (feedback taps 3, 10)
    G2: x^10 + x^9 + x^8 + x^6 + x^3 + x^2 + 1 (taps 2, 3, 6, 8, 9, 10)
    Output chip = G1[10] xor (G2[s1] xor G2[s2]).
    """
    if not 1 <= prn <= N_PRN:
        raise ValueError(f"PRN must be 1..{N_PRN}, got {prn}")
    s1, s2 = G2_TAPS[prn]
    g1 = np.ones(10, dtype=np.int64)
    g2 = np.ones(10, dtype=np.int64)
    out = np.empty(CA_CHIPS, dtype=np.int8)
    for i in range(CA_CHIPS):
        bit = g1[9] ^ g2[s1 - 1] ^ g2[s2 - 1]
        out[i] = 2 * bit - 1
        fb1 = g1[2] ^ g1[9]
        fb2 = g2[1] ^ g2[2] ^ g2[5] ^ g2[7] ^ g2[8] ^ g2[9]
        g1 = np.roll(g1, 1)
        g2 = np.roll(g2, 1)
        g1[0] = fb1
        g2[0] = fb2
    return out


def first_chips_octal(prn: int, n: int = 10) -> int:
    """First-n-chips of a PRN as the IS-GPS-200 check octal (chip 1 -> bit 1)."""
    bits = (ca_chips(prn)[:n] + 1) // 2
    return int("".join(str(int(b)) for b in bits), 2)


def resample_code(chips: np.ndarray, code_samples: int) -> np.ndarray:
    """Resample 1023 chips to `code_samples` points.

    At the reference rate (2048) this matches the reference semantics
    exactly (src/gpslib.py:62-77): each chip is doubled (2046 points at
    x = 0..2045), then linearly interpolated onto code_samples points
    spanning [0, 2045] inclusive.

    At other rates the chips are zero-order-held (sample n carries the
    chip under it).  Stretching the reference's doubled-then-interpolate
    formula to higher rates would smear every chip transition into a
    ~code_samples/2046-sample linear ramp — measured at 16384: the
    correlation apex flattens to a <1%%-per-sample dome, erasing the
    fine code-phase precision the high-rate mode exists for.
    """
    chips = np.asarray(chips, dtype=DSP_FLOAT)
    if code_samples == 2 * CA_CHIPS + 2:
        doubled = np.repeat(chips, 2)
        x = np.arange(doubled.size, dtype=DSP_FLOAT)
        xp = np.linspace(x[0], x[-1], code_samples, endpoint=True,
                         dtype=DSP_FLOAT)
        return np.interp(xp, x, doubled).astype(DSP_FLOAT)
    idx = (np.arange(code_samples, dtype=np.int64) * CA_CHIPS) \
        // code_samples
    return chips[idx]


@functools.lru_cache(maxsize=None)
def _tables(code_samples: int) -> tuple[np.ndarray, np.ndarray]:
    codes = np.zeros((N_PRN + 1, code_samples), dtype=DSP_FLOAT)
    for prn in range(1, N_PRN + 1):
        codes[prn] = resample_code(ca_chips(prn), code_samples)
    ffts = np.fft.fft(codes, axis=-1).astype(np.complex64)
    codes.setflags(write=False)
    ffts.setflags(write=False)
    return codes, ffts


def ca_table(cfg: ReceiverConfig) -> np.ndarray:
    """float32[38, code_samples] resampled codes; row index = PRN (0 unused)."""
    return _tables(cfg.code_samples)[0]


def ca_fft_table(cfg: ReceiverConfig) -> np.ndarray:
    """complex64[38, code_samples] FFT of each resampled code."""
    return _tables(cfg.code_samples)[1]
