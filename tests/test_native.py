"""Native ingest library (csrc/ingest.cpp) vs the numpy reference path.

The capture format is the reference's packed uint16 (256*Q + I,
normalized v/127.5 - (1+1j), src/gpsrecv.py:168-172); the native unpack
must be bit-identical to the numpy fallback."""

import numpy as np
import pytest

native = pytest.importorskip("gps_sdr.runtime._native")

from gps_sdr.runtime import sources  # noqa: E402
from gps_sdr.runtime.buffer import make_buffer  # noqa: E402


def _numpy_unpack(words):
    # correctly-rounded reference: double math, single rounding to f32
    im, re = np.divmod(words, 256)
    return (np.float32(re / 127.5 - 1.0)
            + 1j * np.float32(im / 127.5 - 1.0)).astype(np.complex64)


def test_unpack_matches_numpy():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 65536, size=10000, dtype=np.uint16)
    np.testing.assert_array_equal(native.unpack_iq(words),
                                  _numpy_unpack(words))


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(1)
    words = rng.integers(0, 65536, size=4096, dtype=np.uint16)
    iq = _numpy_unpack(words)
    np.testing.assert_array_equal(native.pack_iq(iq), words)
    # and against the numpy pack
    np.testing.assert_array_equal(native.pack_iq(iq), sources.pack_iq(iq))


def test_unpack_file(tmp_path):
    rng = np.random.default_rng(2)
    words = rng.integers(0, 65536, size=8192, dtype=np.uint16)
    path = tmp_path / "cap.bin"
    words.tofile(path)
    blk = native.unpack_iq_file(str(path), 1024, 2048)
    np.testing.assert_array_equal(blk, _numpy_unpack(words[1024:3072]))
    assert native.unpack_iq_file(str(path), 8000, 2048) is None  # short


def test_native_ring_drop_oldest():
    ring = native.NativeRing(capacity=4, block_samples=8)
    mk = lambda v: np.full(8, v + 0j, np.complex64)
    for v in range(6):          # overflow at v=4: clears 4, drops 4
        ring.push(mk(v))
    assert len(ring) == 2       # blocks 4, 5 remain
    blk, skipped = ring.pop()
    assert skipped == 4
    np.testing.assert_array_equal(blk, mk(4))
    blk, skipped = ring.pop()
    assert skipped == 0
    np.testing.assert_array_equal(blk, mk(5))
    assert ring.pop() is None
    ring.close()


def test_native_ring_concurrent_overflow():
    """Producer overruns a tiny ring while a consumer drains it.

    Pins the CAS-based drop-oldest fix: every delivered block must be
    internally consistent (never torn), delivered + skipped must account
    for every push, and sequence numbers must be strictly increasing."""
    import threading

    n_push, cap, blk = 3000, 4, 64
    ring = native.NativeRing(capacity=cap, block_samples=blk)
    blocks = [np.full(blk, v + 0j, np.complex64) for v in range(n_push)]

    def produce():
        for b in blocks:
            ring.push(b)

    got, skips = [], 0
    t = threading.Thread(target=produce)
    t.start()
    done = False
    while not done:
        done = not t.is_alive()
        while True:                      # drain (again after join: no race)
            r = ring.pop()
            if r is None:
                break
            b, s = r
            vals = np.unique(b.real)
            assert vals.size == 1, f"torn block: {vals}"
            got.append(int(vals[0]))
            skips += s
    t.join()
    assert len(got) + skips == n_push
    assert got == sorted(got) and len(set(got)) == len(got)
    assert got[-1] == n_push - 1         # newest block always survives
    ring.close()


def test_make_buffer_prefers_native():
    buf = make_buffer(4, block_samples=16)
    assert type(buf).__name__ == "_RingAdapter"
    b = np.arange(16, dtype=np.complex64)
    buf.push(b)
    out, skipped = buf.pull()
    np.testing.assert_array_equal(out, b)
    assert skipped == 0


def test_navscan_native_matches_python(monkeypatch):
    """The native subframe scanner (csrc/navscan.cpp) must reproduce
    the Python walk exactly — decoded dicts, ST anchors, and the
    buffer-trim position — on buffers with noise prefixes, inverted
    streams, parity-corrupted subframes, and false preambles."""
    pytest.importorskip("gps_sdr.models._navscan")
    import numpy as np

    from gps_sdr.models import navmsg

    rng = np.random.default_rng(7)

    def build_stream(flip_prob, invert, corrupt_every):
        chunks = [((rng.integers(0, 2, rng.integers(5, 60)) * 2 - 1)
                   .astype(np.int8))]           # noise prefix
        for k in range(4):
            sub = navmsg.encode_subframe(
                1 if k % 2 == 0 else 3, {}, tow=1000 + 6 * k)
            pm = (2 * sub - 1).astype(np.int8)
            if corrupt_every and k % corrupt_every == 1:
                pm[17] = -pm[17]                # parity break
            chunks.append(pm)
        bits = np.concatenate(chunks)
        if invert:
            bits = (-bits).astype(np.int8)
        flips = rng.random(bits.shape[0]) < flip_prob
        bits = np.where(flips, -bits, bits).astype(np.int8)
        return bits

    def scan(bits, native):
        nd = navmsg.NavDecoder(ngps=65536)
        nd.bits = bits.copy()
        nd.bits_st = np.arange(bits.shape[0], dtype=np.int64) * 1313
        with monkeypatch.context() as m:
            m.setenv("GSDR_NAVSCAN", "1" if native else "0")
            out = nd._scan_buffer()
        return out, nd.bits.copy(), nd.bits_st.copy()

    n_decoded = 0
    for case in range(12):
        bits = build_stream(flip_prob=[0.0, 0.0, 0.002][case % 3],
                            invert=case % 2 == 1,
                            corrupt_every=[0, 2][case % 2])
        got_n, bits_n, st_n = scan(bits, True)
        got_p, bits_p, st_p = scan(bits, False)
        assert got_n == got_p, f"case {case}: dict mismatch"
        np.testing.assert_array_equal(bits_n, bits_p)
        np.testing.assert_array_equal(st_n, st_p)
        n_decoded += len(got_n)
    assert n_decoded >= 20      # the cases actually decoded subframes


# -- native host evaluator core (csrc/evalcore.cpp) ---------------------------

# gate per-fixture, NOT module-level importorskip: a missing
# libgsdreval.so must not silently skip the ingest/navscan parity
# tests above, which guard independent native libraries
@pytest.fixture
def evalcore():
    return pytest.importorskip("gps_sdr._evalcore")


def _synth_eph(rng):
    """A plausible broadcast ephemeris dict (all 26 EPHEM_KEYS)."""
    from gps_sdr.models.pseudorange import EPHEM_KEYS
    eph = {
        "weekNum": 2200, "Tgd": rng.normal(0, 5e-9),
        "Toc": 302400.0 + rng.uniform(-1000, 1000),
        "af2": 0.0, "af1": rng.normal(0, 1e-11),
        "af0": rng.normal(0, 1e-4), "IODC": 17, "satAcc": 0,
        "Crs": rng.normal(0, 50), "deltaN": rng.normal(4.5e-9, 5e-10),
        "M0": rng.uniform(-np.pi, np.pi), "Cuc": rng.normal(0, 5e-6),
        "e": rng.uniform(0.001, 0.02), "Cus": rng.normal(0, 5e-6),
        "sqrtA": 5153.6 + rng.normal(0, 1.0),
        "Toe": 302400.0 + rng.uniform(-1000, 1000), "IODE2": 17,
        "Cic": rng.normal(0, 2e-7), "omegaBig": rng.uniform(-np.pi, np.pi),
        "Cis": rng.normal(0, 2e-7),
        "i0": 0.96 + rng.normal(0, 0.02), "Crc": rng.normal(200, 30),
        "omegaSmall": rng.uniform(-np.pi, np.pi),
        "omegaDot": rng.normal(-8e-9, 5e-10),
        "IDOT": rng.normal(0, 3e-10), "IODE3": 17,
    }
    assert set(eph) == set(EPHEM_KEYS)
    return eph


def test_evalcore_ecef_matches_python(evalcore):
    """Native Kepler/ECEF propagation vs orbits.ecef_coord: sub-um
    agreement over random ephemerides, times, and both rel_corr modes."""
    from gps_sdr.models import orbits
    from gps_sdr.models.pseudorange import EPHEM_KEYS

    rng = np.random.default_rng(11)
    n = 64
    ephs = [_synth_eph(rng) for _ in range(n)]
    mat = np.array([[e[k] for k in EPHEM_KEYS] for e in ephs])
    tow = rng.integers(1, 100000, n).astype(np.float64)
    dt = rng.uniform(-10, 10, n)
    eph_cols = {k: mat[:, i] for i, k in enumerate(EPHEM_KEYS)}
    for rel in (True, False):
        xp, yp, zp, dtp = orbits.ecef_coord(tow, eph_cols,
                                            dt_from_tow=dt, rel_corr=rel)
        xn, yn, zn, dtn = evalcore.ecef_batch(tow, dt, mat, rel)
        np.testing.assert_allclose(
            np.stack([xn, yn, zn]), np.stack([xp, yp, zp]),
            rtol=0, atol=1e-6)
        np.testing.assert_allclose(dtn, dtp, rtol=0, atol=1e-18)


def _fix_problem(rng, E, n, pad=0):
    """Synthetic fix geometry: truth receiver + satellites at GPS
    radius; delays include a clock offset; optional padded duplicate
    columns at sigma 1e7 (the _fix_prepare convention)."""
    from gps_sdr.config import GPS_C
    rec = np.array([4157000.0, 606000.0, 4775000.0])
    coords = np.empty((E, 3, n + pad))
    delays = np.empty((E, n + pad))
    sig = np.empty((E, n + pad))
    for ei in range(E):
        u = rng.normal(size=(n, 3))
        u[:, 2] = np.abs(u[:, 2])
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        sats = rec + u * 2.2e7 + rng.normal(0, 1e5, (n, 3))
        rngs = np.linalg.norm(sats - rec, axis=1)
        d = rngs / GPS_C + 0.068 + rng.normal(0, 3e-9, n)
        coords[ei, :, :n] = sats.T
        delays[ei, :n] = d
        sig[ei, :n] = rng.uniform(2.0, 40.0, n)
        if pad:
            coords[ei, :, n:] = coords[ei, :, n - 1:n]
            delays[ei, n:] = delays[ei, n - 1]
            sig[ei, n:] = 1.0e7
    return coords, delays, sig


@pytest.mark.parametrize("height,rp0,crf", [
    (None, None, 0.0),
    (None, "per_epoch", 3e-6),
    (146.0, "shared", 0.0),
])
def test_evalcore_fix_batch_matches_python(evalcore, monkeypatch,
                                           height, rp0, crf):
    from gps_sdr.ops.pvt import solve_fix_batch

    rng = np.random.default_rng(5)
    E, n = 24, 7
    coords, delays, sig = _fix_problem(rng, E, n, pad=2)
    kw = dict(std_dev=sig, max_it=15, max_residual=1e-9 * 3e8 / 10,
              height=height, height_dev=1.0, clock_rate_fix=crf)
    if rp0 == "per_epoch":
        kw["rec_pos0"] = np.tile(
            np.array([0.0, 4156990.0, 606010.0, 4774980.0]), (E, 1))
    elif rp0 == "shared":
        kw["rec_pos0"] = np.array([0.0, 4156990.0, 606010.0, 4774980.0])

    with monkeypatch.context() as m:
        m.setenv("GSDR_EVALCORE", "0")
        ref = solve_fix_batch(coords, delays, **kw)
    with monkeypatch.context() as m:
        m.setenv("GSDR_EVALCORE", "1")
        got = solve_fix_batch(coords, delays, **kw)

    np.testing.assert_allclose(got.pos, ref.pos, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.range_est, ref.range_est,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.meas_delay, ref.meas_delay,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.res_m, ref.res_m, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.cov, ref.cov, rtol=1e-6, atol=1e-9)
    assert np.all(np.abs(got.n_iter - ref.n_iter) <= 1)
    # both converged below the gate (residual plateaus at the ~1e-2
    # Sagnac re-linearization level; the gate here is 0.03)
    assert np.all(got.residual < 0.03) and np.all(ref.residual < 0.03)


def test_evalcore_sigma_slope_matches_python(evalcore, monkeypatch):
    """Sequential per-chunk calls must evolve the slope history and the
    per-entry sigma/slope identically to the numpy walk."""
    from gps_sdr.config import ReceiverConfig
    from gps_sdr.models.pseudorange import PseudorangeEngine

    cfg = ReceiverConfig()

    def run(native):
        rng = np.random.default_rng(3)      # same stream both runs
        eng = PseudorangeEngine(5, cfg)
        outs = []
        sno = 1
        with monkeypatch.context() as m:
            m.setenv("GSDR_EVALCORE", "1" if native else "0")
            for chunk in range(12):
                # variable-length, gap-riddled series spanning segment
                # boundaries; occasional tiny segments (< 4 entries)
                k = int(rng.integers(2, 2 * cfg.no_sec))
                snos = sno + np.cumsum(rng.integers(1, 4, k))
                sno = int(snos[-1]) + int(rng.integers(1, 20))
                cps = (1000.0 + 0.003 * snos
                       + rng.normal(0, 0.3, k))
                outs.append(eng._sigma_and_slope(snos, cps))
        return outs, list(eng.slope_hist)

    ref, hist_ref = run(False)
    got, hist_got = run(True)
    np.testing.assert_allclose(hist_got, hist_ref, rtol=1e-12)
    for (sig_n, slp_n), (sig_p, slp_p) in zip(got, ref):
        np.testing.assert_allclose(sig_n, sig_p, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(slp_n, slp_p, rtol=1e-9, atol=1e-15)


def test_evalcore_unwrap_matches_python(evalcore, monkeypatch):
    """Overflow unwrap + phase-error voting: corrected series, error
    votes, and log lines must match the numpy path."""
    from gps_sdr.config import ReceiverConfig
    from gps_sdr.runtime.evaluator import unwrap_code_phases

    cfg = ReceiverConfig()
    cs = cfg.code_samples
    rng = np.random.default_rng(9)

    def build():
        n = 400
        snos = 1 + np.cumsum(rng.integers(1, 3, n))
        cps = 2000.0 - 0.02 * np.arange(n) + rng.normal(0, 0.2, n)
        cps = cps % cs                        # genuine wraps
        cps[137] += 40.0                      # impossible step (error)
        return list(zip(snos.tolist(), cps.tolist()))

    lst = build()

    def run(native):
        err, log = {}, []
        with pytest.MonkeyPatch.context() as m:
            m.setenv("GSDR_EVALCORE", "1" if native else "0")
            cpl, err = unwrap_code_phases(5, list(lst), err, None, cfg,
                                          log)
        return cpl, err, log

    cpl_p, err_p, log_p = run(False)
    cpl_n, err_n, log_n = run(True)
    assert err_n == err_p and len(err_p) > 0
    assert log_n == log_p and len(log_p) > 0
    np.testing.assert_array_equal(cpl_n.snos, cpl_p.snos)
    np.testing.assert_allclose(cpl_n.vals, cpl_p.vals, rtol=1e-12)
