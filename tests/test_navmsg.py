"""Nav-message codec tests: parity, field round-trip, inversion handling."""

import numpy as np
import pytest

from gps_sdr.models import navmsg

SF1 = {
    "weekNum": 312, "satAcc": 0, "satHealth": 0, "IODC": 437,
    "Tgd": -6 * 2.0 ** -31, "Toc": 266400, "af2": 0.0,
    "af1": -3 * 2.0 ** -43, "af0": 655 * 2.0 ** -31,
}
SF2 = {
    "IODE2": 181, "Crs": -112.03125, "deltaN": 4.5e-9, "M0": 1.23456,
    "Cuc": -5.9e-6, "e": 0.0123456, "Cus": 7.4e-6,
    "sqrtA": 5153.672, "Toe": 266400,
}
SF3 = {
    "Cic": 2.4e-8, "omegaBig": -0.87654, "Cis": -1.1e-7, "i0": 0.9597,
    "Crc": 221.125, "omegaSmall": -1.8, "omegaDot": -8.1e-9,
    "IDOT": 4.0e-10, "IODE3": 181,
}


@pytest.mark.parametrize("sf_id,fields", [(1, SF1), (2, SF2), (3, SF3),
                                          (4, {}), (5, {})])
def test_subframe_roundtrip(sf_id, fields):
    tow = 44400
    tx = navmsg.encode_subframe(sf_id, fields, tow)
    assert tx.shape == (300,)
    dec = navmsg.decode_subframe(tx)
    assert dec is not None
    assert dec["ID"] == sf_id
    assert dec["tow"] == tow
    for name, v in fields.items():
        if isinstance(v, int):
            assert dec[name] == v, name
        else:
            scale = navmsg.field_scale(sf_id, name)
            expect = round(v / scale) * scale  # field LSB quantization
            assert dec[name] == pytest.approx(expect, rel=1e-12), name


def test_inverted_subframe_decodes():
    tx = navmsg.encode_subframe(2, SF2, tow=101)
    dec = navmsg.decode_subframe(1 - tx)
    assert dec is not None and dec["ID"] == 2 and dec["tow"] == 101


def test_parity_error_rejected():
    tx = navmsg.encode_subframe(3, SF3, tow=7)
    bad = tx.copy()
    bad[75] ^= 1  # flip one data bit in word 3
    assert navmsg.decode_subframe(bad) is None


def test_preamble_error_rejected():
    tx = navmsg.encode_subframe(1, SF1, tow=7)
    bad = tx.copy()
    bad[0] ^= 1
    assert navmsg.decode_subframe(bad) is None


def test_forced_zero_tail_words():
    """HOW and word 10 must be transmitted with D29 = D30 = 0 so each
    subframe starts from known parity (and TLM is never inverted)."""
    tx = navmsg.encode_subframe(1, SF1, tow=12345).reshape(10, 30)
    assert tx[1, 28] == 0 and tx[1, 29] == 0
    assert tx[9, 28] == 0 and tx[9, 29] == 0
    np.testing.assert_array_equal(tx[0, :8], navmsg.PREAMBLE)


def test_navdecoder_bit_framing():
    """Edges 20 ms apart with the r>17 rounding rule frame correct bits."""
    nd = navmsg.NavDecoder(ngps=65536)
    # bit sequence +1 +1 -1 +1 (edges at ms 40, 60, 80); one edge 2 ms early
    nd.last_sign = 1
    nd.edges = [(0, 1000), (40, 2000), (58, 3000), (80, 4000), (100, 5000)]
    bits, sts = nd._frame_bits()
    np.testing.assert_array_equal(bits, [1, 1, -1, 1, -1])
    np.testing.assert_array_equal(sts, [1000, 0, 2000, 3000, 4000])
    assert nd.edges == [(100, 5000)]
    assert nd.last_sign == 1  # flipped once per edge (4 edges consumed)


def test_navdecoder_full_chain():
    """A synthetic edge stream spanning two subframes decodes both."""
    tow0 = 1200
    stream = np.concatenate([
        navmsg.encode_subframe(4, {}, tow0),
        navmsg.encode_subframe(1, SF1, tow0 + 1),
    ])
    pm = (2 * stream - 1).astype(np.int8)
    nd = navmsg.NavDecoder(ngps=65536)
    nd.last_sign = int(pm[0])
    # build edges from sign flips; prepend a start edge at ms 0
    ms0 = 500
    edges = [(ms0, ms0 * 2048)]
    for i in range(1, len(pm)):
        if pm[i] != pm[i - 1]:
            t = ms0 + 20 * i
            edges.append((t, t * 2048))
    t_end = ms0 + 20 * len(pm)
    edges.append((t_end, t_end * 2048))
    nd.edges = edges
    subs = nd.poll_subframes()
    assert len(subs) == 2
    assert subs[0]["ID"] == 4 and subs[0]["tow"] == tow0
    assert subs[1]["ID"] == 1 and subs[1]["tow"] == tow0 + 1
    assert subs[0]["ST"] == ms0 * 2048
    assert subs[1]["ST"] == (ms0 + 20 * 300) * 2048
    for k, v in SF1.items():
        scale = navmsg.field_scale(1, k)
        assert subs[1][k] == pytest.approx(round(v / scale) * scale,
                                           rel=1e-12)


def test_frame_bits_matches_sequential():
    """The vectorized edge->bit assembly equals the per-edge walk
    (logicalBits, /root/reference/src/gpslib.py:1465-1492) on random
    edge streams, including sub-20 ms glitch intervals (m=0)."""
    rng = np.random.default_rng(7)
    for trial in range(30):
        n_edges = int(rng.integers(2, 60))
        t = 100 + np.cumsum(rng.integers(1, 85, size=n_edges))
        edges = [(int(tt), int(tt) * 2048 + int(rng.integers(0, 2048)))
                 for tt in t]
        sign0 = int(rng.choice([-1, 1]))

        nd = navmsg.NavDecoder(ngps=65536)
        nd.edges = list(edges)
        nd.last_sign = sign0
        bits, sts = nd._frame_bits()

        # sequential oracle
        obits, osts = [], []
        sign = sign0
        (t1, st1) = edges[0]
        for (t2, st2) in edges[1:]:
            m, r = divmod(t2 - t1, 20)
            if r > 17:
                m += 1
            if m > 0:
                obits.extend([sign] * m)
                osts.extend([st1] + [0] * (m - 1))
            t1, st1 = t2, st2
            sign = -sign
        assert bits.tolist() == obits
        assert sts.tolist() == osts
        assert nd.last_sign == sign
        assert nd.edges == [edges[-1]]
