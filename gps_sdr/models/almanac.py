"""Almanac handling: reduced-precision orbits + visible-sat prediction.

The reference discards subframes 4/5 outright (decode stubs commented
out, /root/reference/src/gpslib.py:373-377), so it can never warm-start
acquisition: every cold start sweeps all 31 PRNs over the full Doppler
grid.  With a decoded almanac (models/navmsg.py `_ALMANAC` pages), a
receiver that knows roughly where and when it is can predict which SVs
are above the horizon and at what Doppler, shrinking the acquisition
search from 31 PRNs x full band to ~10 PRNs x a few bins.

The almanac is a reduced-precision ephemeris (IS-GPS-200 20.3.3.5.2.3:
same Kepler propagation with the harmonic-correction terms, deltaN and
IDOT zeroed, and i0 = 0.30 semicircles + deltaI), so the coarse orbit
reuses models/orbits.ecef_coord unchanged.  Pure float64 host math.
"""

from __future__ import annotations

import numpy as np

from gps_sdr.config import GPS_C, GPS_PI, L1_FREQ
from gps_sdr.models import orbits

_ALM_I0 = 0.30 * GPS_PI          # nominal inclination [rad]

# fields carried by one almanac page (models/navmsg.py _ALMANAC)
ALM_KEYS = ("almE", "almToa", "almDeltaI", "almOmegaDot", "almHealth",
            "almSqrtA", "almOmega0", "almOmegaSmall", "almM0",
            "almAf0", "almAf1")


def almanac_from_ephem(eph: dict) -> dict:
    """Reduced-precision almanac fields for one SV's ephemeris (what
    the control segment uploads: the same orbit, truncated to almanac
    LSBs — the simulator uses this to broadcast consistent pages).

    toa's LSB is 4096 s, so the epoch-referenced elements (M0, RAAN,
    inclination, clock) must be RE-REFERENCED from Toe to the quantized
    toa before truncation — propagating the full-precision secular
    rates over (toa - Toe), exactly how real almanacs are generated —
    or the coarse orbit would be off by up to n0 * 2048 s ~ 0.3 rad of
    mean anomaly."""
    toa = round(float(eph["Toe"]) / 4096.0) * 4096.0
    dt = toa - float(eph["Toe"])
    n = np.sqrt(orbits.MU_EARTH) / float(eph["sqrtA"]) ** 3 \
        + float(eph["deltaN"])

    def wrap(x):      # angles are encoded as 2^-23-semicircle ints: +-pi
        return float((x + np.pi) % (2.0 * np.pi) - np.pi)

    return {
        "almE": eph["e"],
        "almToa": toa,
        "almDeltaI": (eph["i0"] + eph["IDOT"] * dt) - _ALM_I0,
        "almOmegaDot": eph["omegaDot"],
        "almHealth": 0,
        "almSqrtA": eph["sqrtA"],
        "almOmega0": wrap(eph["omegaBig"] + eph["omegaDot"] * dt),
        "almOmegaSmall": wrap(eph["omegaSmall"]),
        "almM0": wrap(eph["M0"] + n * dt),
        "almAf0": eph["af0"] + eph["af1"] * (toa - float(eph["Toc"])),
        "almAf1": eph["af1"],
    }


def ephem_from_almanac(alm: dict, week_num: int = 0) -> dict:
    """Expand almanac fields into the full-ephemeris key set with the
    IS-GPS-200-specified zeros, so orbits.ecef_coord applies as-is."""
    return {
        "weekNum": week_num, "satAcc": 0,
        "satHealth": int(alm.get("almHealth", 0)),
        "IODC": 0, "Tgd": 0.0,
        "Toc": float(alm["almToa"]), "af2": 0.0,
        "af1": float(alm["almAf1"]), "af0": float(alm["almAf0"]),
        "Crs": 0.0, "deltaN": 0.0, "M0": float(alm["almM0"]),
        "Cuc": 0.0, "e": float(alm["almE"]), "Cus": 0.0,
        "sqrtA": float(alm["almSqrtA"]), "Toe": float(alm["almToa"]),
        "Cic": 0.0, "omegaBig": float(alm["almOmega0"]), "Cis": 0.0,
        "i0": _ALM_I0 + float(alm["almDeltaI"]), "Crc": 0.0,
        "omegaSmall": float(alm["almOmegaSmall"]),
        "omegaDot": float(alm["almOmegaDot"]), "IDOT": 0.0,
        "IODE2": 0, "IODE3": 0,
    }


def almanac_ecef(tow, alm: dict, dt_from_tow=0.0):
    """Coarse ECEF position of one SV at (tow, dt) from its almanac."""
    x, y, z, _ = orbits.ecef_coord(tow, ephem_from_almanac(alm),
                                   dt_from_tow=dt_from_tow)
    return np.stack([np.asarray(x), np.asarray(y), np.asarray(z)],
                    axis=-1)


def predict_visible(almanacs: dict, rec_ecef, tow: int,
                    min_elev_deg: float = 5.0) -> list:
    """Predict visible SVs and their Doppler from a PRN->almanac dict.

    Returns [(prn, elev_deg, doppler_hz)] sorted by descending
    elevation, healthy SVs only.  Doppler is the geometric L1 shift for
    a static receiver (range-rate by central difference over 1 s) —
    accurate to a few hundred Hz against the precise ephemeris, i.e.
    one or two acquisition bins (cfg.step_freq = 200 Hz).
    """
    from gps_sdr.models.atmosphere import azim_elev_batch

    rec = np.asarray(rec_ecef, np.float64)
    out = []
    for prn, alm in sorted(almanacs.items()):
        if int(alm.get("almHealth", 0)) != 0:
            continue
        p = almanac_ecef(tow, alm, dt_from_tow=np.array([-0.5, 0.0, 0.5]))
        el, _ = azim_elev_batch(rec, p[1])
        el_deg = float(np.rad2deg(el[0]))
        if el_deg < min_elev_deg:
            continue
        rate = (np.linalg.norm(p[2] - rec) - np.linalg.norm(p[0] - rec))
        out.append((int(prn), el_deg, float(-rate / GPS_C * L1_FREQ)))
    out.sort(key=lambda e: -e[1])
    return out


def acquisition_hints(almanacs: dict, rec_ecef, tow: int,
                      step_freq: float = 200.0,
                      margin_hz: float = 600.0,
                      max_prns: int | None = None):
    """(prns, doppler_bins) for a warm-started cold acquisition.

    The PRN list shrinks from all 31 to the predicted-visible set and
    the Doppler grid to the predicted span +- `margin_hz` (almanac
    prediction error is ~1 bin; the margin absorbs receiver-clock ppm
    residue).  Returns (None, None) when the almanac predicts too few
    satellites to be worth trusting."""
    vis = predict_visible(almanacs, rec_ecef, tow)
    if max_prns is not None:
        vis = vis[:max_prns]
    if len(vis) < 4:
        return None, None
    dops = np.array([v[2] for v in vis])
    lo = np.floor((dops.min() - margin_hz) / step_freq) * step_freq
    hi = np.ceil((dops.max() + margin_hz) / step_freq) * step_freq
    bins = np.arange(lo, hi + step_freq / 2, step_freq, dtype=np.float64)
    return [v[0] for v in vis], bins
