"""C/A code generation tests against IS-GPS-200 published check values."""

import numpy as np
import pytest

from gps_sdr.config import DEFAULT
from gps_sdr.ops import cacode

# First-10-chip octals, IS-GPS-200 table 3-I (PRN 34 == PRN 37).
FIRST10_OCTAL = {
    1: 0o1440, 2: 0o1620, 3: 0o1710, 4: 0o1744, 5: 0o1133, 6: 0o1455,
    7: 0o1131, 8: 0o1454, 9: 0o1626, 10: 0o1504, 11: 0o1642, 12: 0o1750,
    13: 0o1764, 14: 0o1772, 15: 0o1775, 16: 0o1776, 17: 0o1156, 18: 0o1467,
    19: 0o1633, 20: 0o1715, 21: 0o1746, 22: 0o1763, 23: 0o1063, 24: 0o1706,
    25: 0o1743, 26: 0o1761, 27: 0o1770, 28: 0o1774, 29: 0o1127, 30: 0o1453,
    31: 0o1625, 32: 0o1712, 33: 0o1745, 34: 0o1713, 35: 0o1134, 36: 0o1456,
    37: 0o1713,
}


@pytest.mark.parametrize("prn", sorted(FIRST10_OCTAL))
def test_first_chips_octal(prn):
    assert cacode.first_chips_octal(prn) == FIRST10_OCTAL[prn]


def test_chip_values_and_length():
    for prn in (1, 17, 32):
        chips = cacode.ca_chips(prn)
        assert chips.shape == (1023,)
        assert set(np.unique(chips)) <= {-1, 1}
        # Gold codes of period 1023 are near-balanced: 512 ones, 511 zeros.
        assert np.sum(chips == 1) == 512


def test_gold_code_correlation_properties():
    """Circular autocorrelation peak 1023 at lag 0; Gold cross/off-peak
    correlation takes only the values {-65, -1, 63}."""
    a = cacode.ca_chips(5).astype(np.int64)
    b = cacode.ca_chips(9).astype(np.int64)
    fa, fb = np.fft.fft(a), np.fft.fft(b)
    auto = np.round(np.fft.ifft(fa * np.conj(fa)).real).astype(int)
    cross = np.round(np.fft.ifft(fa * np.conj(fb)).real).astype(int)
    assert auto[0] == 1023
    assert set(auto[1:]) <= {-65, -1, 63}
    assert set(cross) <= {-65, -1, 63}


def test_resample_semantics():
    """Chip-doubling + linear interpolation (reference gpslib.py:62-77):
    2048 points span [0, 2045]; doubled-chip plateaus are preserved."""
    chips = cacode.ca_chips(1)
    code = cacode.resample_code(chips, 2048)
    assert code.shape == (2048,)
    assert code[0] == chips[0]
    assert code[-1] == chips[-1]
    # interior points are within the chip range and mostly exactly +-1
    assert np.max(np.abs(code)) <= 1.0
    assert np.mean(np.abs(np.abs(code) - 1.0) < 1e-6) > 0.7


def test_tables():
    codes = cacode.ca_table(DEFAULT)
    ffts = cacode.ca_fft_table(DEFAULT)
    assert codes.shape == (38, 2048)
    assert ffts.shape == (38, 2048)
    assert codes.dtype == np.float32 and ffts.dtype == np.complex64
    assert np.all(codes[0] == 0)
    np.testing.assert_allclose(
        np.fft.fft(codes[7]), ffts[7], rtol=1e-4, atol=1e-2)
