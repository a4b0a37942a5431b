"""Digital front end: FIR decimation + DDC (ops/frontend.py).

The reference only ingests 2.048 MS/s complex baseband from an RTL-SDR;
these tests pin the decimator against a numpy reference (including the
chunk-seam state), recover a tone through the real-IF DDC, and run
high-rate synthetic captures through the decimator into the standard
acquisition + tracking chain.
"""

import numpy as np
import pytest

from gps_sdr.config import ReceiverConfig
from gps_sdr.models.simulator import SatSignal, synth_stream
from gps_sdr.ops import cacode
from gps_sdr.ops.acquisition import acquire_all
from gps_sdr.ops.frontend import (Frontend, decimation_taps,
                                  design_lowpass, frontend_blocks)

CFG = ReceiverConfig()          # 2.048 MS/s output chain
FACTOR = 4
CFG_HI = ReceiverConfig(code_samples=FACTOR * 2048)   # 8.192 MS/s


def test_decimator_matches_numpy_and_chunk_seams():
    rng = np.random.default_rng(0)
    n = 40_000
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64)
    taps = decimation_taps(FACTOR)
    # numpy reference: the frontend seam starts zero-filled (uniform
    # streaming; the first (taps-1)//factor outputs are the startup
    # transient), so the reference convolves the zero-prefixed input
    xp = np.concatenate([np.zeros(len(taps) - 1, np.complex64), x])
    ref = np.convolve(xp, taps, mode="valid")[::FACTOR]

    one = Frontend(FACTOR).feed(x)
    assert np.allclose(one, ref.astype(np.complex64), atol=2e-6)

    # chunked feed with awkward sizes must be bit-compatible
    fe = Frontend(FACTOR)
    outs = []
    i = 0
    for size in (7, 1000, 3, 8191, 12345, n):
        outs.append(fe.feed(x[i:i + size]))
        i += size
        if i >= n:
            break
    chunked = np.concatenate(outs)
    assert chunked.shape == one.shape
    assert np.allclose(chunked, one, atol=2e-6)


def test_lowpass_response():
    taps = design_lowpass(65, 0.25)
    w = np.fft.rfftfreq(8192)
    h = np.abs(np.fft.rfft(taps, 8192))
    # unit DC gain, passband flat, stopband down >40 dB
    assert h[0] == pytest.approx(1.0, abs=1e-6)
    assert np.all(h[w < 0.08] > 0.95)
    assert np.all(h[w > 0.22] < 0.01)


def test_ddc_recovers_tone():
    fs_in = 8.192e6
    f_if = 2.048e6
    df = 1300.0                       # baseband offset to recover
    n = 65536
    t = np.arange(n) / fs_in
    real_if = np.cos(2 * np.pi * (f_if + df) * t).astype(np.float32)
    fe = Frontend(FACTOR, f_if=f_if, fs_in=fs_in)
    out = fe.feed(real_if)
    assert out.size > 15000
    # Hann window: rectangular leakage from the main tone (~1.6% at
    # the image offset) would otherwise swamp the image measurement
    spec = np.abs(np.fft.fft(out * np.hanning(out.size)))
    f_axis = np.fft.fftfreq(out.size, FACTOR / fs_in)
    peak = f_axis[np.argmax(spec)]
    assert abs(peak - df) < fs_in / FACTOR / out.size * 2
    # desired sideband amplitude 0.5 (|out| is flat for a complex
    # exponential; the FFT peak would leak for a non-bin-centered
    # tone), image suppressed by the stopband
    amp = float(np.median(np.abs(out[200:])))
    assert 0.45 < amp < 0.55
    image = np.max(spec[np.abs(f_axis + df) < 200.0])
    assert image < 0.02 * spec.max()


def _hi_rate_sats():
    return [
        SatSignal(prn=5, doppler=1850.0, code_delay=1200.0,
                  amplitude=1.0),
        SatSignal(prn=12, doppler=-3200.0, code_delay=6000.0,
                  amplitude=0.9),
        SatSignal(prn=29, doppler=400.0, code_delay=8188.0,
                  amplitude=0.9),
    ]


def test_high_rate_capture_through_decimator_acquires():
    """8.192 MS/s synthetic capture -> decimate /4 -> standard
    acquisition: every satellite found at the right Doppler and at the
    decimated code phase + the FIR group delay."""
    sats = _hi_rate_sats()
    hi = synth_stream(CFG_HI, sats, n_blocks=1, noise_std=0.5, seed=2)
    blocks = list(frontend_blocks(iter([hi.reshape(-1)]), CFG, FACTOR))
    assert len(blocks) >= 1
    found = acquire_all(CFG, blocks[0], cacode.ca_fft_table(CFG))
    by_prn = {prn: (freq, delay) for _, prn, freq, delay in found}
    taps = decimation_taps(FACTOR)
    gd = (len(taps) - 1) // 2 / FACTOR        # output samples
    assert set(by_prn) >= {5, 12, 29}
    for s in sats:
        freq, delay = by_prn[s.prn]
        assert abs(freq - s.doppler) <= CFG.step_freq
        want = (s.code_delay / FACTOR + gd) % CFG.code_samples
        d = abs(delay - want)
        assert min(d, CFG.code_samples - d) <= 2.0, (s.prn, delay, want)


def test_high_rate_capture_tracks_and_locks():
    """~2.6 s of decimated high-rate capture through the full Receiver:
    channels activate from the cold sweep and reach carrier lock."""
    from gps_sdr.ops.tracking import summarize_states
    from gps_sdr.runtime.receiver import Receiver

    sats = _hi_rate_sats()
    n_blocks = 82
    hi = synth_stream(CFG_HI, sats, n_blocks=n_blocks, noise_std=0.5,
                      seed=4)
    src = frontend_blocks((hi[i].reshape(-1) for i in range(n_blocks)),
                          CFG, FACTOR)
    rec = Receiver(CFG)
    for _ in rec.run(src):
        pass
    assert set(rec.slots.active) >= {5, 12, 29}
    states = {k: np.asarray(v) for k, v in
              summarize_states(CFG, rec.states).items()}
    locked = 0
    for s in sats:
        slot = rec.slots.slot_prn.index(s.prn)
        if states["locked"][slot] > 0.5:
            locked += 1
            assert abs(float(states["freq"][slot]) - s.doppler) < 15.0
    assert locked >= 3


def test_replay_decimated_file_roundtrip(tmp_path):
    """High-rate captures on disk (both formats) replay through
    runtime/sources.replay_decimated into standard blocks that match
    the in-memory frontend path."""
    from gps_sdr.ops.frontend import Frontend
    from gps_sdr.runtime.sources import pack_iq, replay_decimated

    sats = _hi_rate_sats()
    hi = synth_stream(CFG_HI, sats, n_blocks=2, noise_std=0.3,
                      seed=7).reshape(-1)
    fs_in = CFG_HI.sample_rate

    # packed-IQ capture at 4x rate
    p_iq = str(tmp_path / "hi_iq.bin")
    pack_iq(0.25 * hi).tofile(p_iq)
    blocks = list(replay_decimated(p_iq, CFG, fs_in))
    assert len(blocks) == 2 and blocks[0].shape == (CFG.ngps,)
    fe = Frontend(4)
    from gps_sdr.runtime.sources import unpack_iq
    want = fe.feed(unpack_iq(np.fromfile(p_iq, np.uint16)))
    assert np.array_equal(np.concatenate(blocks),
                          want[:2 * CFG.ngps])
    # start_stream skips OUTPUT blocks
    b1 = list(replay_decimated(p_iq, CFG, fs_in, start_stream=1))
    assert len(b1) == 1 and np.array_equal(b1[0], blocks[1])

    # real-IF int16 capture: upconvert the complex signal to a real IF
    f_if = fs_in / 4
    t = np.arange(hi.size) / fs_in
    real_if = np.real(0.2 * hi * np.exp(2j * np.pi * f_if * t))
    p_re = str(tmp_path / "hi_if.bin")
    (real_if * 32767).astype(np.int16).tofile(p_re)
    blocks = list(replay_decimated(p_re, CFG, fs_in, f_if=f_if,
                                   fmt="real16"))
    assert len(blocks) == 2
    found = acquire_all(CFG, blocks[0], cacode.ca_fft_table(CFG))
    assert {prn for _, prn, _, _ in found} >= {5, 12, 29}

    # non-integer rate rejected
    with pytest.raises(ValueError):
        list(replay_decimated(p_iq, CFG, 3.5 * CFG.sample_rate))
