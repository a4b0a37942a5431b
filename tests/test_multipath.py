"""Multipath and narrowband-interference survival.

The reference's only realism evidence is that its rooftop capture —
with real specular reflections and RFI — produces a fix
(/root/reference/README.md:177-185); its 8-sigma acquisition gate and
3-sigma edge gate exist because real signals are dirty
(gpsrecv.py:36, gpslib.py:1395-1435).  The scenario oracle now models
both impairments (SatScenario.multipath, Scenario.cw_tones); this file
pins the measured degradation envelope and the countermeasures:

  * multipath @ 2.048 MS/s: a 0.5-amplitude specular ray biases the
    code phase up to ~+-60 m (physics: the complex-baseband capture is
    band-limited to +-1.024 MHz, so the correlation apex is smeared
    over ~1 sample and no discriminator trick can see inside the
    smear).  Tracking and decode survive; fixes degrade to tens of
    meters.  Countermeasure = the WIDEBAND front end: at 16 MS/s the
    correlator spacing is 1/16 chip and the same ray's bias collapses
    below ~8 m (narrow-correlator physics, enabled by the ZOH code
    replica fix in ops/cacode.py resample_code).
  * CW interference: a tone at J/S ~ +20 dB captures EVERY channel's
    PLL (common several-hundred-Hz drag; measured) and destroys
    decode.  Countermeasure = frequency-domain excision
    (cfg.cw_excision, ops/frontend.py): one DFT per block nulls the
    tone's bins; the closed loop then matches the tone-free result
    exactly.

Measured degradation table (single sat, 0.5-amp ray, in-phase /
anti-phase bias in meters; tracking never loses lock):

    delay   2.048 MS/s      16 MS/s (ZOH replica)
    0.10 ch   +9 / -30       +5 / -8
    0.25 ch  +23 / -55       +5 / -8
    0.50 ch  +44 / -58       +5 / -8
    0.75 ch  +59 / -48       +5 / -8
    1.00 ch  +52 / -33       +3 / -4
    2.00 ch   +5 /  -6        .  /  .

Closed loop (8 sats, mixed 0.3-0.7 chip rays, random phases, 36 s):
2.048 MS/s fixes at ~36 m mean; +CW tone amp 10 -> NO fixes; +CW with
excision -> 36 m again (identical to tone-free).  16 MS/s closed loop
with the same rays (measured once, 14 s, 6 sats, preloaded ephems —
too slow for CI at ~11 min on the 1-core host): mean fix error
6.60 m, i.e. the wideband mode holds <10 m under multipath that costs
the reference-rate loop 36 m.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from gps_sdr.config import GPS_C, ReceiverConfig
from gps_sdr.models.simulator import SatSignal, random_bits, synth_stream
from gps_sdr.ops import cacode
from gps_sdr.ops.tracking import (init_channel_states, outs_to_numpy,
                                  reset_channel, track_chunk)
from tests.conftest import _SYNTH_CACHE

BITS = random_bits(128, seed=17)
N_BLOCKS = 24


def _track_bias(cfg, delay_chips, rel_amp, rel_phase, key):
    """Mean tracked-code-phase error [m] for one sat + optional ray."""
    from tests.conftest import cached_synth

    cs = cfg.code_samples
    chip = cs / 1023.0
    fs = cfg.sample_rate
    direct = SatSignal(prn=17, doppler=-1500.0, code_delay=900.25,
                       nav_bits=BITS)
    sats = [direct]
    if rel_amp > 0:
        sats.append(SatSignal(prn=17, doppler=-1500.0,
                              code_delay=900.25 + delay_chips * chip,
                              amplitude=rel_amp, carrier_phase=rel_phase,
                              nav_bits=BITS))
    blocks = cached_synth(key, lambda: synth_stream(
        cfg, sats, N_BLOCKS, noise_std=0.5, seed=4))
    states = init_channel_states(cfg, 1)
    states = reset_channel(states, 0, 17, direct.doppler,
                           int(direct.code_delay), cfg)
    _, outs = track_chunk(cfg, states, jnp.asarray(blocks), jnp.int32(1),
                          jnp.asarray(cacode.ca_table(cfg)[17][None]),
                          jnp.asarray(cacode.ca_fft_table(cfg)[17][None]))
    o = outs_to_numpy(outs)
    got = o.code_phase[:, 0]
    true = np.array([
        (direct.code_delay + direct.delay_rate(cfg)
         * ((b * cfg.ngps + cfg.ngps // 2) / fs)) % cs
        for b in range(N_BLOCKS)])
    ok = got >= 0
    assert ok.mean() > 0.9, "correlation lost under multipath"
    err = ((got[ok] - true[ok] + cs / 2) % cs - cs / 2)[5:]
    return float(err.mean()) * GPS_C / fs


def test_multipath_bias_envelope_2msps():
    """Reference-rate envelope: bias peaks near half-chip delays and
    decays once the ray leaves the correlation triangle; lock holds."""
    cfg = ReceiverConfig()
    clean = _track_bias(cfg, 0, 0, 0, "mp2_clean_v1")
    assert abs(clean) < 3.0
    mid = _track_bias(cfg, 0.5, 0.5, 0.0, "mp2_d05_v1")
    far = _track_bias(cfg, 2.0, 0.5, 0.0, "mp2_d20_v1")
    anti = _track_bias(cfg, 0.5, 0.5, np.pi, "mp2_d05pi_v1")
    assert 20.0 < mid < 80.0, f"in-phase half-chip bias {mid:.1f} m"
    assert anti < -20.0, f"anti-phase bias {anti:.1f} m"
    assert abs(far) < 15.0, f"2-chip ray should decorrelate: {far:.1f} m"


def test_multipath_bias_collapses_at_16msps():
    """The wideband front end is the multipath countermeasure: 1/16-chip
    correlator spacing (ZOH replica, ops/cacode.py) collapses the same
    ray's bias by ~7x."""
    cfg = ReceiverConfig(code_samples=16384, n_cyc=8, corr_avg=4)
    clean = _track_bias(cfg, 0, 0, 0, "mp16_clean_v1")
    assert abs(clean) < 4.0
    for d, ph, key in ((0.5, 0.0, "mp16_d05_v1"),
                       (0.5, np.pi, "mp16_d05pi_v1"),
                       (0.25, 0.0, "mp16_d025_v1")):
        b = _track_bias(cfg, d, 0.5, ph, key)
        assert abs(b) < 12.0, f"16 MS/s bias at d={d} ph={ph}: {b:.1f} m"


def _tone(cfg, n_blocks, freq_hz, amp):
    """Continuous-phase CW tone across blocks: [n_blocks, ngps] c64."""
    n = n_blocks * cfg.ngps
    t = np.arange(n, dtype=np.float64) / cfg.sample_rate
    return (amp * np.exp(2j * np.pi * freq_hz * t)) \
        .astype(np.complex64).reshape(n_blocks, cfg.ngps)


def test_cw_excision_restores_tracking():
    """A +40 dB J/S tone collapses the correlation (norm below the
    8-sigma gate, lock lost); cw_excision removes it and tracking
    matches the clean run.  (PLL *frequency* capture needs tens of
    seconds at the 20 Hz/s slew limit — the closed-loop test covers
    that; here the fast observable is correlation quality.)"""
    from tests.conftest import cached_synth

    cfg = ReceiverConfig()
    sat = SatSignal(prn=17, doppler=-1500.0, code_delay=900.25,
                    nav_bits=BITS)
    blocks = cached_synth("cw_base_v1", lambda: synth_stream(
        cfg, [sat], N_BLOCKS, noise_std=0.5, seed=4))
    jam = blocks + _tone(cfg, N_BLOCKS, 1500.0, 100.0)

    def run(cfg_run, blk):
        states = init_channel_states(cfg_run, 1)
        states = reset_channel(states, 0, 17, sat.doppler,
                               int(sat.code_delay), cfg_run)
        states, outs = track_chunk(
            cfg_run, states, jnp.asarray(blk), jnp.int32(1),
            jnp.asarray(cacode.ca_table(cfg_run)[17][None]),
            jnp.asarray(cacode.ca_fft_table(cfg_run)[17][None]))
        o = outs_to_numpy(outs)
        return (float(np.mean(o.norm_max[5:, 0])),
                float(np.asarray(states.freq[0])),
                float(np.mean(o.locked[5:, 0])))

    norm_jam, _, locked_jam = run(cfg, jam)
    norm_fix, f_fix, locked_fix = run(
        ReceiverConfig(cw_excision=12.0), jam)
    assert norm_jam < 14.0, f"tone did not degrade corr: {norm_jam:.1f}"
    assert locked_jam < 0.5, "lock survived +40 dB J/S?"
    assert norm_fix > 20.0, f"excision left corr degraded: {norm_fix:.1f}"
    assert locked_fix > 0.5
    assert abs(f_fix - sat.doppler) < 2.0, (
        f"excision failed: freq err {f_fix - sat.doppler:+.1f} Hz")


SEC = 36.0
MP_CFG = ReceiverConfig(cw_excision=12.0)


def _mp_scenario():
    from gps_sdr.models.scenario import make_scenario

    scn = make_scenario(MP_CFG, n_sats=8, duration_sec=SEC + 12.0, seed=2,
                        cw=((1500.0, 10.0, 0.4),))
    rng = np.random.default_rng(7)
    for s in scn.sats:
        s.multipath = (float(rng.uniform(0.3, 0.7)), 0.5,
                       float(rng.uniform(0, 2 * np.pi)))
    return scn


def _mp_capture_path():
    from gps_sdr.models.scenario_jax import DeviceScenarioSynth
    from gps_sdr.runtime.sources import pack_iq

    os.makedirs(_SYNTH_CACHE, exist_ok=True)
    path = os.path.join(_SYNTH_CACHE, "mp_cw_capture_v1.bin")
    if os.path.exists(path):
        return path
    dev = DeviceScenarioSynth(_mp_scenario(), noise_std=1.0)
    n_blocks = int(round(SEC / MP_CFG.block_sec))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        done = 0
        while done < n_blocks:
            k = min(MP_CFG.no_sec, n_blocks - done)
            pack_iq(0.05 * np.asarray(dev.chunk(done, k))).tofile(f)
            done += k
    os.replace(tmp, path)
    return path


def test_multipath_cw_closed_loop():
    """Full receiver on an 8-sat capture with mixed specular rays AND a
    PLL-capturing CW tone.  Without excision this capture produces ZERO
    fixes (measured); with it, the result equals the tone-free run:
    every PRN tracked on its true Doppler, subframes decoded, fixes at
    the multipath-physics floor (~36 m at 2.048 MS/s)."""
    from gps_sdr.config import L1_FREQ
    from gps_sdr.ops.tracking import summarize_states
    from gps_sdr.runtime.session import Session
    from gps_sdr.runtime.sources import replay_blocks

    scn = _mp_scenario()
    path = _mp_capture_path()
    session = Session(MP_CFG)
    session.run_source(replay_blocks(path, MP_CFG))
    ev = session.evaluator
    rec = session.receiver

    assert ev.stat is not None, "no fixes under CW + excision"
    pos = np.array([p[1:4] for p in ev.positions])
    assert len(pos) >= 200
    merr = np.linalg.norm(np.asarray(ev.stat[0]) - scn.rec_ecef)
    assert merr < 60.0, f"mean fix error {merr:.1f} m"

    # PLLs must sit on the TRUE Dopplers (the tone pulled every channel
    # several hundred Hz off without excision)
    states = {k: np.asarray(v)
              for k, v in summarize_states(MP_CFG, rec.states).items()}
    t_end = SEC - 1.0
    checked = 0
    for slot, prn in enumerate(rec.slots.slot_prn):
        if prn == 0 or states["locked"][slot] < 0.5:
            continue
        sat = next(s for s in scn.sats if s.prn == prn)
        ts = scn.t_rx0 + np.array([t_end, t_end + 1.0])
        tau = scn.sat_states(ts, sat)[0]
        true_dop = -L1_FREQ * (tau[1] - tau[0])
        assert abs(states["freq"][slot] - true_dop) < 10.0, (
            f"PRN {prn} tracked {states['freq'][slot]:.0f} Hz vs true "
            f"{true_dop:.0f} Hz")
        checked += 1
    assert checked >= 5, f"only {checked} locked channels"
