"""Headless text reporter: the GUI's information surface without Qt.

Prints the same quantities the reference GUI displays (gpsui.py:104-166,
362-413): per-satellite table (PRN/AMP/COR/FRQ/TOW/ID/EPH with '*' for
position-contributing sats), ECEF/geodetic statistics, and the error
counters (skipped blocks / outliers / LSF failures / phase errors).
"""

from __future__ import annotations

import sys

import numpy as np

from gps_sdr.utils.geodesy import ecef_to_geo


class HeadlessReporter:
    def __init__(self, out=None, every_sec: int = 1):
        self.out = out or sys.stdout
        self.every = every_sec
        self._n = 0
        self._sat_rows: dict[int, dict] = {}

    def update(self, epoch_frames: list, summary: dict,
               evaluator) -> None:
        for sf in epoch_frames:
            sat = sf.get("SAT")
            if sat is None:
                continue
            row = self._sat_rows.setdefault(sat, {})
            row.update(amp=sf.get("AMP", 0.0), cor=sf.get("CRM", 0.0),
                       frq=sf.get("FRQ", 0.0), eph=sf.get("EPH", ""))
            if "CN0" in sf:
                # EMA over reports: the per-block estimate carries
                # ~1-2 dB of scatter (ops/tracking.py cn0_from_amp)
                row["cn0"] = 0.7 * row.get("cn0", sf["CN0"]) \
                    + 0.3 * sf["CN0"]
            if "tow" in sf:
                row.update(tow=sf["tow"], sfid=sf["ID"])
            if sf.get("SWP"):
                row["swp"] = True
        self._n += 1
        if self._n % self.every:
            return
        p = self.out.write
        used = summary.get("active_sats", set())
        gps_time = summary.get("gps_time")
        p(f"\n== t={gps_time} fixes={summary.get('n_fixes', 0)}\n")
        p("PRN    AMP  C/N0   COR     FRQ      TOW ID EPH\n")
        for sat in sorted(self._sat_rows):
            r = self._sat_rows[sat]
            mark = "*" if sat in used else " "
            p(f"{mark}{sat:02d}  {r.get('amp', 0):5.1f}"
              f" {r.get('cn0', 0):5.1f} {r.get('cor', 0):5.1f}"
              f" {r.get('frq', 0):+8.1f} {r.get('tow', 0):8d}"
              f" {r.get('sfid', 0):2d} {r.get('eph', ''):>3s}"
              f"{' SWEEP' if r.pop('swp', False) else ''}\n")
        stat = summary.get("stat")
        if stat is not None:
            mean, dev, n, n_out = stat
            lat, lon, alt = ecef_to_geo(mean)
            p(f"mean ECEF ({mean[0]:.1f}, {mean[1]:.1f}, {mean[2]:.1f}) m"
              f"  sd ({dev[0]:.1f}, {dev[1]:.1f}, {dev[2]:.1f}) m  n={n}\n")
            p(f"geo  {lat:.6f} deg, {lon:.6f} deg, {alt:.1f} m\n")
        dop = summary.get("dop")
        if dop is not None:
            p(f"DOP  G={dop[0]:.1f} P={dop[1]:.1f} H={dop[2]:.1f} "
              f"V={dop[3]:.1f}\n")
        vel = summary.get("velocity")
        if vel is not None:
            p(f"vel  {np.linalg.norm(vel.vel):5.2f} m/s "
              f"ECEF ({vel.vel[0]:+.2f}, {vel.vel[1]:+.2f}, "
              f"{vel.vel[2]:+.2f})  drift {vel.clock_drift * 1e6:+.3f} "
              f"ppm\n")
        p(f"errors: skip={summary.get('skipped_blocks', 0)}"
          f" outliers={summary.get('n_outliers', 0)}"
          f" lsf_fail={summary.get('n_fails', 0)}"
          f" phase={summary.get('n_phase_errors', 0)}\n")
        self.out.flush()
