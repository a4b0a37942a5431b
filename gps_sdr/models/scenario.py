"""Physically consistent GPS scenario simulation.

Generates IQ streams from first principles — receiver position +
per-satellite ephemerides -> geometric propagation delays, Doppler,
SV clock offsets, and a parity-correct navigation message — so the FULL
receiver chain (acquisition -> tracking -> bit sync -> subframe decode ->
ephemeris assembly -> pseudoranges -> Gauss-Newton fix) can be verified
in closed loop against exact ground truth.  The reference has no such
oracle; its only end-to-end check is a recorded capture
(/root/reference README.md:177-185).

Signal model per receiver sample at GPS time t:
  tau_prop(t):   light time to the satellite, solved by fixed-point
                 iteration with the Sagnac frame rotation applied
  tau_sv(t)    = t - tau_prop(t) + dtsv: the SATELLITE-CLOCK time whose
                 chip is arriving now (code and data are clocked by the
                 SV clock; dtsv from the ephemeris clock model)
  chip         = ca[floor(frac(tau_sv/1ms) * 1023)]  (1.023 Mcps)
  bit          = nav_stream[floor(tau_sv / 20 ms)]
  carrier      = exp(-j*2*pi*f_L1*tau_prop(t))  (baseband after an ideal
                 L1 downconversion)
Subframe k's preamble leaves the SV at sat-clock time 6k, so its HOW
carries tow = k+1 — exactly the timing the receiver's TOW walking
assumes (models/pseudorange.py; reference gpslib.py:475-476).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gps_sdr.config import (BIT_MS, CA_CHIP_RATE, CA_CHIPS, GPS_C,
                            L1_FREQ, OMEGA_EARTH, ReceiverConfig)
from gps_sdr.models import navmsg, orbits
from gps_sdr.ops.cacode import ca_chips
from gps_sdr.utils.geodesy import geo_to_ecef


def quantized_ephemeris(eph: dict) -> dict:
    """Round ephemeris values to their broadcast LSBs so the simulated
    geometry matches what the receiver will decode bit-exactly."""
    out = dict(eph)
    for sf_id in (1, 2, 3):
        for name, _, _, scale in navmsg._SF_FIELDS[sf_id]:
            if name in out and scale != 1:
                out[name] = round(out[name] / scale) * scale
    return out


def random_visible_ephemeris(rec_ecef: np.ndarray, tow0: int, week: int,
                             rng: np.random.Generator,
                             min_elev_sin: float = 0.3) -> dict:
    """Draw orbital elements on the GPS shell until the satellite is
    above the horizon at the receiver at the scenario start."""
    t_ref = orbits.tsv_of_tow(tow0)
    toe = float(np.floor(t_ref / 16) * 16)
    up = rec_ecef / np.linalg.norm(rec_ecef)
    while True:
        eph = {
            "weekNum": week, "satAcc": 0, "satHealth": 0,
            "IODC": int(rng.integers(1, 1023)),
            "Tgd": float(rng.uniform(-1e-8, 1e-8)),
            "Toc": toe, "af2": 0.0,
            "af1": float(rng.uniform(-1e-11, 1e-11)),
            "af0": float(rng.uniform(-5e-4, 5e-4)),
            "Crs": float(rng.uniform(-80, 80)),
            "deltaN": float(rng.uniform(-6e-9, 6e-9)),
            "M0": float(rng.uniform(-np.pi, np.pi)),
            "Cuc": float(rng.uniform(-6e-6, 6e-6)),
            "e": float(rng.uniform(0.001, 0.02)),
            "Cus": float(rng.uniform(-6e-6, 6e-6)),
            "sqrtA": float(np.sqrt(26_560_000.0) + rng.uniform(-5, 5)),
            "Toe": toe,
            "Cic": float(rng.uniform(-2e-7, 2e-7)),
            "omegaBig": float(rng.uniform(-np.pi, np.pi)),
            "Cis": float(rng.uniform(-2e-7, 2e-7)),
            "i0": float(np.deg2rad(55) + rng.uniform(-0.1, 0.1)),
            "Crc": float(rng.uniform(-200, 200)),
            "omegaSmall": float(rng.uniform(-np.pi, np.pi)),
            "omegaDot": float(rng.uniform(-8.5e-9, -7.5e-9)),
            "IDOT": float(rng.uniform(-4e-10, 4e-10)),
        }
        eph["IODE2"] = eph["IODE3"] = eph["IODC"] & 255
        eph = quantized_ephemeris(eph)
        x, y, z, _ = orbits.ecef_coord(tow0, eph)
        d = np.array([x, y, z]) - rec_ecef
        if np.dot(d, up) / np.linalg.norm(d) > min_elev_sin:
            return eph


@dataclass
class SatScenario:
    prn: int
    eph: dict
    amplitude: float = 1.0
    nav_stream: np.ndarray = None   # +-1 bits, bit b spans sat time
    #                                 [20ms*(b + bit0), ...)
    bit0: int = 0                   # global bit index of nav_stream[0]
    fault_dtsv: float = 0.0         # SV-clock fault [s]: shifts the
    #                                 code/data timing WITHOUT touching
    #                                 the broadcast clock model — the
    #                                 classic integrity fault RAIM must
    #                                 catch (1 us = ~300 m of range)
    multipath: tuple | None = None  # specular ray (delay_chips,
    #                                 rel_amp, rel_phase_rad): a second
    #                                 copy of the signal at +delay
    #                                 chips of path, rel_amp relative
    #                                 amplitude, and rel_phase of extra
    #                                 carrier rotation ON TOP of the
    #                                 physical -2*pi*L1*delta phase —
    #                                 the dominant real-capture
    #                                 impairment the reference's
    #                                 test.bin demonstrably survives
    #                                 (README.md:177-185) and the one
    #                                 thing the clean oracle never
    #                                 exercised

    def build_nav_stream(self, tow_first: int, n_subframes: int,
                         page_fields=None):
        """Encode subframes tow_first..+n cycling IDs 1..5 with the
        correct ephemeris payload.

        `page_fields(sf_id, tow) -> dict | None` supplies subframe-4/5
        page payloads (iono page 18, almanac pages); None / absent
        encodes a dummy-SV page."""
        frames = []
        for k in range(n_subframes):
            tow = tow_first + k
            sf_id = (tow - 1) % 5 + 1
            if sf_id in (1, 2, 3):
                fields = self.eph
            else:
                fields = (page_fields(sf_id, tow) if page_fields
                          else None) or {}
            frames.append(navmsg.encode_subframe(sf_id, fields, tow))
        bits01 = np.concatenate(frames)
        self.nav_stream = (2 * bits01 - 1).astype(np.int8)
        # subframe with HOW tow starts at sat time (tow-1)*6 -> bit index
        self.bit0 = (tow_first - 1) * 300


@dataclass
class Scenario:
    """Ground truth for one simulation run."""

    cfg: ReceiverConfig
    rec_geo: tuple                      # (lat, lon, alt)
    rec_ecef: np.ndarray
    week: int
    tow0: int                           # first subframe TOW in nav streams
    t_rx0: float                        # GPS time of receiver sample 0
    sats: list                          # [SatScenario]
    # Receiver-oscillator error model (the reference's operating envelope
    # is a +-2 ppm TCXO: common Doppler offset ~ ppm * L1 ~ +-3.1 kHz,
    # drift up to ~2.6 Hz/s, and a sample-clock skew that makes EVERY
    # satellite's code phase drift together at ~ppm*fs samples/s —
    # reference README.md:204-217, drift feed-forward gpslib.py:1226-1229).
    # One oscillator drives both the LO and the ADC, so a single
    # fractional-error trajectory y(t) = 1e-6*(ppm + ppm_rate*t) models
    # both: sample n lands at true GPS time  t_rx0 + n/fs - clock_err(n/fs)
    # and the downconverted carrier gains the extra phase
    # -2*pi*L1*clock_err.
    osc_ppm: float = 0.0                # fractional offset at t=0 [ppm]
    osc_ppm_rate: float = 0.0           # drift [ppm/s]
    # Atmospheric truth model (models/atmosphere.py): when set, every
    # satellite's signal picks up the Klobuchar ionospheric and/or
    # Saastamoinen tropospheric group delay along its line of sight —
    # the systematic meter-class error source the reference never
    # models (README.md:26).  iono_alpha/iono_beta are the broadcast
    # page-18 coefficients (quantized), also encoded into the nav
    # message so the receiver can decode and correct them.
    iono_alpha: tuple | None = None
    iono_beta: tuple | None = None
    model_tropo: bool = False
    # Receiver motion: constant ECEF velocity [m/s]; rec_ecef is the
    # position at receiver time 0 (sample 0).  The reference's track
    # plot displays motion but its only test input is a static rooftop
    # capture — a moving closed loop is new capability.
    rec_vel: np.ndarray | None = None
    # Narrowband (CW) interference: tuple of (freq_hz, amplitude,
    # phase0_rad) tones.  freq_hz is the tone's RF offset from L1; the
    # shared-oscillator downconversion leaves baseband phase
    # 2*pi*(f*t - L1*clock_err(t)), so tones ride the same LO error as
    # the satellites.  Amplitude is in the same units as sat
    # amplitudes (correlation processing gain over one code period is
    # ~33 dB; a tone of amplitude 30 is ~ +30 dB J/S over a unit sat).
    cw_tones: tuple = ()

    def rec_at(self, t):
        """Receiver ECEF position at GPS time(s) t: [..., 3]."""
        if self.rec_vel is None:
            return np.broadcast_to(self.rec_ecef,
                                   np.shape(t) + (3,))
        dt = np.asarray(t, np.float64) - self.t_rx0
        return self.rec_ecef + dt[..., None] * self.rec_vel

    def clock_err(self, dt):
        """Accumulated receiver-clock error [s] at nominal receiver
        time dt [s] since sample 0 (positive = receiver clock fast)."""
        return 1e-6 * (self.osc_ppm * dt
                       + 0.5 * self.osc_ppm_rate * dt * dt)

    def sat_states(self, t: np.ndarray, sat: SatScenario):
        """(tau_prop, tau_sv) at GPS times t for one satellite, with
        Sagnac rotation and SV clock offset applied."""
        tow_ref = self.tow0
        t_rel = t - orbits.tsv_of_tow(tow_ref)
        rec = np.moveaxis(self.rec_at(t), -1, 0)        # [3, ...]
        tau = np.full_like(t, 0.07)
        for _ in range(3):
            x, y, z, dtsv = orbits.ecef_coord(tow_ref, sat.eph,
                                              dt_from_tow=t_rel - tau)
            ang = OMEGA_EARTH * tau
            c, s = np.cos(ang), np.sin(ang)
            xr = c * x + s * y
            yr = -s * x + c * y
            rng = np.sqrt((xr - rec[0]) ** 2
                          + (yr - rec[1]) ** 2
                          + (z - rec[2]) ** 2)
            tau = rng / GPS_C
        if self.iono_alpha is not None or self.model_tropo:
            # atmospheric group delay along the line of sight; applied
            # to tau (carrier) AND tau_sv (code/data timing).  The
            # ionosphere's equal-and-opposite carrier-phase ADVANCE is
            # not modeled: it only matters through code-carrier
            # divergence, which is sub-centimeter over the Hatch
            # filter's ~100-block windows at these delay dynamics.
            from gps_sdr.models.atmosphere import (azim_elev_batch,
                                                   klobuchar_delay,
                                                   tropo_delay)
            sat_xyz = np.stack([np.atleast_1d(xr), np.atleast_1d(yr),
                                np.atleast_1d(z)], axis=1)
            el, az = azim_elev_batch(self.rec_ecef, sat_xyz)
            el = el.reshape(np.shape(tau))
            az = az.reshape(np.shape(tau))
            if self.iono_alpha is not None:
                lat, lon, _ = self.rec_geo
                tau = tau + klobuchar_delay(
                    self.iono_alpha, self.iono_beta, np.deg2rad(lat),
                    np.deg2rad(lon), el, az,
                    np.mod(t, 7 * 86400.0))
            if self.model_tropo:
                tau = tau + tropo_delay(el, self.rec_geo[2])
        tau_sv = t - tau + dtsv + sat.fault_dtsv
        return tau, tau_sv


# typical mid-latitude broadcast coefficients, chosen as exact
# multiples of the page-18 LSBs
DEFAULT_IONO_ALPHA = (1.1176e-08, 1.4901e-08, -5.9605e-08, -1.1921e-07)
DEFAULT_IONO_BETA = (90112.0, 49152.0, -131072.0, -327680.0)


def _quantize_iono(alpha, beta):
    """Round iono coefficients to their broadcast LSBs so the injected
    truth matches what the receiver decodes bit-exactly."""
    qa = tuple(round(v / navmsg.field_scale(4, f"alpha{i}"))
               * navmsg.field_scale(4, f"alpha{i}")
               for i, v in enumerate(alpha))
    qb = tuple(round(v / navmsg.field_scale(4, f"beta{i}"))
               * navmsg.field_scale(4, f"beta{i}")
               for i, v in enumerate(beta))
    return qa, qb


def make_scenario(cfg: ReceiverConfig, n_sats: int = 6,
                  rec_geo=(49.082961, 8.307581, 150.0),
                  week: int = 312, tow0: int = 11100,
                  rx_start_offset: float = 0.25,
                  duration_sec: float = 40.0,
                  seed: int = 0, osc_ppm: float = 0.0,
                  osc_ppm_rate: float = 0.0,
                  iono: bool | tuple = False, tropo: bool = False,
                  broadcast_almanac: bool = False,
                  rec_vel_enu: tuple | None = None,
                  multipath: dict | None = None,
                  cw: tuple = ()) -> Scenario:
    """Build a scenario: receiver at `rec_geo` (default: the reference's
    golden-fix coordinates, README.md:185), `n_sats` visible satellites
    with randomized ephemerides, nav streams covering `duration_sec`.
    osc_ppm/osc_ppm_rate inject the receiver-TCXO error model (common
    Doppler offset + code-clock skew; see Scenario).

    iono=True injects Klobuchar ionospheric delays (DEFAULT_IONO_* or a
    custom (alpha, beta) tuple) and broadcasts the coefficients in
    subframe 4 page 18; tropo=True injects tropospheric delays;
    broadcast_almanac=True cycles every satellite's almanac page through
    the subframe-5 slots (for warm-start acquisition tests).
    rec_vel_enu=(east, north, up) m/s moves the receiver at constant
    velocity (rec_geo is the position at sample 0).

    multipath maps PRN (or the key "*" for every satellite) to a
    specular-ray tuple (delay_chips, rel_amp, rel_phase_rad); cw is a
    tuple of (freq_hz, amplitude, phase0_rad) narrowband interferers —
    see SatScenario.multipath / Scenario.cw_tones."""
    rng = np.random.default_rng(seed)
    rec_ecef = np.array(geo_to_ecef(*rec_geo))
    t_rx0 = orbits.tsv_of_tow(tow0) + rx_start_offset
    iono_alpha = iono_beta = None
    if iono:
        a, b = iono if isinstance(iono, tuple) else (DEFAULT_IONO_ALPHA,
                                                     DEFAULT_IONO_BETA)
        iono_alpha, iono_beta = _quantize_iono(a, b)

    sats = []
    prns = rng.choice(np.arange(2, 33), size=n_sats, replace=False)
    n_subframes = int(np.ceil(duration_sec / 6)) + 3
    for prn in prns:
        eph = random_visible_ephemeris(rec_ecef, tow0, week, rng)
        mp = None
        if multipath is not None:
            mp = multipath.get(int(prn), multipath.get("*"))
        sats.append(SatScenario(prn=int(prn), eph=eph,
                                amplitude=float(rng.uniform(0.7, 1.2)),
                                multipath=mp))

    page18 = None
    if iono_alpha is not None:
        page18 = {"dataID": 1, "svID": navmsg.IONO_PAGE_SVID,
                  "dtLS": 18, "utcWNt": week & 255}
        page18.update({f"alpha{i}": v for i, v in enumerate(iono_alpha)})
        page18.update({f"beta{i}": v for i, v in enumerate(iono_beta)})
    alm_pages = []
    if broadcast_almanac:
        from gps_sdr.models.almanac import almanac_from_ephem
        for s in sats:
            page = almanac_from_ephem(s.eph)
            page.update({"dataID": 1, "svID": s.prn})
            alm_pages.append(page)

    def page_fields(sf_id, tow):
        if sf_id == 4:
            return page18
        if sf_id == 5 and alm_pages:
            return alm_pages[(tow // 5) % len(alm_pages)]
        return None

    for sat in sats:
        sat.build_nav_stream(tow0, n_subframes, page_fields)
    rec_vel = None
    if rec_vel_enu is not None:
        from gps_sdr.utils.geodesy import enu_to_ecef_vec
        rec_vel = enu_to_ecef_vec(rec_geo[0], rec_geo[1], rec_vel_enu)
    return Scenario(cfg=cfg, rec_geo=rec_geo, rec_ecef=rec_ecef, week=week,
                    tow0=tow0, t_rx0=t_rx0, sats=sats,
                    osc_ppm=osc_ppm, osc_ppm_rate=osc_ppm_rate,
                    iono_alpha=iono_alpha, iono_beta=iono_beta,
                    model_tropo=tropo, rec_vel=rec_vel,
                    cw_tones=tuple(cw))


def synth_scenario_blocks(scn: Scenario, first_block: int, n_blocks: int,
                          noise_std: float = 0.6,
                          seed: int = 1) -> np.ndarray:
    """Generate blocks [first_block, first_block+n_blocks) of the
    scenario's IQ stream; complex64[n_blocks, ngps].

    Propagation delay and SV clock are evaluated at 1 ms knots and
    linearly interpolated per sample (tau varies < 3 us/s, so knot
    interpolation error is sub-millimeter).
    """
    cfg = scn.cfg
    fs = cfg.sample_rate
    n = n_blocks * cfg.ngps
    sample0 = first_block * cfg.ngps
    # receiver-clock warp: sample k's true GPS time lags the nominal
    # grid by the accumulated oscillator error (Scenario.clock_err) —
    # this alone makes every satellite's code phase drift together at
    # ~ppm*fs samples/s, the skew the evaluator's unwrap/slope logic
    # must absorb
    dt_nom = (sample0 + np.arange(n + 1, dtype=np.float64)) / fs
    t = scn.t_rx0 + dt_nom - scn.clock_err(dt_nom)
    knot_step = cfg.code_samples                      # 1 ms
    knots = t[::knot_step]
    frac = (np.arange(n, dtype=np.float64) % knot_step) / knot_step
    ce_s = scn.clock_err(dt_nom[:-1])                 # per-sample [n]

    out = np.zeros(n, dtype=np.complex128)
    for sat in scn.sats:
        chips = ca_chips(sat.prn).astype(np.float64)
        tau_k0, tau_sv_k0 = scn.sat_states(knots, sat)
        k_idx = np.arange(n) // knot_step
        tau_ref = scn.sat_states(np.array([scn.t_rx0]), sat)[0][0]
        # direct ray + optional specular multipath ray: the reflection
        # travels delta = delay_chips/chip_rate seconds farther, so its
        # chips/bits are OLDER (tau_sv - delta) and its carrier picks
        # up the physical -2*pi*L1*delta plus the configured rel_phase
        rays = [(0.0, 1.0, 0.0)]
        if sat.multipath is not None:
            d_chips, rel_amp, rel_phase = sat.multipath
            rays.append((d_chips / (CA_CHIPS * 1000.0), rel_amp,
                         rel_phase))
        for delta, rel_amp, rel_phase in rays:
            tau_k = tau_k0 + delta
            tau_sv_k = tau_sv_k0 - delta
            tau = tau_k[k_idx] * (1 - frac) + tau_k[k_idx + 1] * frac
            tau_sv = (tau_sv_k[k_idx] * (1 - frac)
                      + tau_sv_k[k_idx + 1] * frac)
            # carrier: keep only the time-varying part of f*tau in the
            # phase (constant offset is an arbitrary carrier phase) to
            # preserve float64 precision.  The reference MUST be
            # chunk-independent — referencing the chunk's own first
            # knot would put a carrier phase jump at every chunk
            # boundary of a chunked synthesis (tau varies < 1.5e-4 s
            # over a scenario, so f*dtau stays well within float64
            # mod-1 precision)
            # LO runs off the same oscillator: downconversion leaves
            # the extra phase -2*pi*L1*clock_err on every satellite
            # (the common Doppler offset, ~ -ppm*L1 Hz)
            dtau = tau - tau_ref
            phase = (-2.0 * np.pi * np.mod(L1_FREQ * (dtau + ce_s), 1.0)
                     + rel_phase)
            # code chip + nav bit indexed by SV clock time
            ms = np.floor(tau_sv * 1000.0)
            chip_idx = np.floor((tau_sv * 1000.0 - ms)
                                * CA_CHIPS).astype(np.int64) % CA_CHIPS
            bit_idx = np.floor(tau_sv * 1000.0 / BIT_MS).astype(np.int64) \
                - sat.bit0
            bits = sat.nav_stream[np.clip(bit_idx, 0,
                                          len(sat.nav_stream) - 1)]
            # cos/sin rather than np.exp(1j*x) — numpy complex exp is
            # ~100x slower than separate real trig on some hosts
            out += (sat.amplitude * rel_amp * bits * chips[chip_idx]
                    * (np.cos(phase) + 1j * np.sin(phase)))
    # CW interference: phase 2*pi*(f*dt_nom - L1*clock_err) — the tone
    # rides the same LO error as the satellites, and dt_nom is
    # scenario-global so chunked synthesis stays phase-continuous
    for f_hz, amp, ph0 in scn.cw_tones:
        ph = (2.0 * np.pi * np.mod(f_hz * dt_nom[:-1] - L1_FREQ * ce_s, 1.0)
              + ph0)
        out += amp * (np.cos(ph) + 1j * np.sin(ph))

    out = out.reshape(n_blocks, cfg.ngps)
    if noise_std > 0:
        for b in range(n_blocks):
            rng = np.random.default_rng((seed, first_block + b))
            out[b] += noise_std * (rng.standard_normal(cfg.ngps)
                                   + 1j * rng.standard_normal(cfg.ngps))
    return out.astype(np.complex64)
