"""Batched acquisition tests on synthetic multi-satellite IQ."""

import numpy as np

from gps_sdr.config import DEFAULT as CFG
from gps_sdr.ops import cacode
from gps_sdr.ops.acquisition import acquire_all
from gps_sdr.models.simulator import SatSignal, synth_stream


def test_acquire_multi_sat():
    truth = [
        SatSignal(prn=5, doppler=1850.0, code_delay=300, amplitude=1.0),
        SatSignal(prn=12, doppler=-3200.0, code_delay=1500, amplitude=0.8),
        SatSignal(prn=29, doppler=400.0, code_delay=2047, amplitude=0.9),
    ]
    blocks = synth_stream(CFG, truth, n_blocks=1, noise_std=1.0, seed=3)
    found = acquire_all(CFG, blocks[0], cacode.ca_fft_table(CFG))
    by_prn = {prn: (corr, freq, delay) for corr, prn, freq, delay in found}

    assert set(by_prn) == {5, 12, 29}
    for s in truth:
        corr, freq, delay = by_prn[s.prn]
        assert corr > CFG.corr_min
        assert abs(freq - s.doppler) <= CFG.step_freq  # grid resolution
        assert min(abs(delay - s.code_delay),
                   CFG.code_samples - abs(delay - s.code_delay)) <= 1


def test_acquire_empty_on_noise():
    rng = np.random.default_rng(0)
    noise = (rng.standard_normal(CFG.ngps)
             + 1j * rng.standard_normal(CFG.ngps)).astype(np.complex64)
    found = acquire_all(CFG, noise, cacode.ca_fft_table(CFG))
    assert found == []


def test_acquire_subset_prns():
    truth = [SatSignal(prn=7, doppler=-1000.0, code_delay=77)]
    blocks = synth_stream(CFG, truth, n_blocks=1, noise_std=0.5, seed=1)
    found = acquire_all(CFG, blocks[0], cacode.ca_fft_table(CFG), prns=[7])
    assert len(found) == 1 and found[0][1] == 7


def test_noncoherent_acquisition_gains_sensitivity():
    """cfg.acq_noncoherent=8 averages |corr| over eight 4 ms windows
    (the whole 32 ms block): a satellite too weak for the reference's
    single-window detection must clear the same 8-sigma floor, at the
    right Doppler and code phase.  k=1 stays reference-exact (covered
    by the tests above)."""
    from gps_sdr.ops.acquisition import acquire
    import jax.numpy as jnp
    from gps_sdr.ops.tracking import to_f32_pairs

    ffts = cacode.ca_fft_table(CFG)
    cfg8 = CFG.replace(acq_noncoherent=8)
    truth = SatSignal(prn=9, doppler=2200.0, code_delay=900,
                      amplitude=1.0)

    def norm_at(cfg, noise_std, seed):
        blocks = synth_stream(cfg, [truth], n_blocks=1,
                              noise_std=noise_std, seed=seed)
        res = acquire(cfg, jnp.asarray(to_f32_pairs(blocks[0])),
                      jnp.asarray(cfg.doppler_bins, np.float32),
                      jnp.asarray(to_f32_pairs(ffts[np.array([9])])))
        return (float(res.norm_max[0]), float(res.found[0]),
                float(res.freq[0]), float(res.delay[0]))

    # at this SNR the single 4 ms window reads 5.4-7.3 sigma (below
    # the 8-sigma floor) while the 8-window average reads 10-14 sigma
    noise = 20.0
    n1 = [norm_at(CFG, noise, s)[1] for s in range(4)]
    assert sum(n1) <= 1, f"single-window still detects at noise {noise}"
    hits = 0
    for s in range(4):
        norm, found, freq, delay = norm_at(cfg8, noise, s)
        if found:
            hits += 1
            assert abs(freq - truth.doppler) <= CFG.step_freq
            assert min(abs(delay - truth.code_delay),
                       CFG.code_samples
                       - abs(delay - truth.code_delay)) <= 1
    assert hits >= 3, f"noncoherent k=8 found only {hits}/4"
