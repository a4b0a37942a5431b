"""Live matplotlib UI: the reference GUI's four quadrants.

Re-creation of the reference's PyQt5/matplotlib window (src/gpsui.py:
32-577) on plain matplotlib (any interactive backend; falls back to Agg
snapshots when no display is available):

  * satellite table: PRN/AMP/COR/FRQ/TOW/ID/EPH with '*' marking sats
    used in the fix (gpsui.py:104-121, 362-390)
  * statistics panel: ECEF/geodetic mean + SD, error counters
    (gpsui.py:124-166, 409-413)
  * EN track plot with auto-rescale and km/m tick relabeling
    (gpsui.py:90-101, 510-576)
  * polar sky plot with per-PRN fixed colors (gpsui.py:21-28, 169-190)

Controls (reference buttons + keys, gpsui.py:193-250, 458-505):
buttons Sweep / Clear Stats & Track / Stop / Show on Map / Close, a
Confine-Height check box, an H= height text box and track-plot zoom
+/- buttons; keys s = sweep, r = clear, q = stop, m = export HTML map,
h = toggle height constraint, +/- = zoom.  Events are collected via
`get_events()` exactly like GpsUI.getEvents so the runtime can forward
them to the receiver control surface.
"""

from __future__ import annotations

import numpy as np

from gps_sdr.utils.geodesy import (ecef_to_azim_elev, ecef_to_geo,
                                   local_offsets_m)

# per-PRN fixed colors (gpsui.py:21-28 uses a tab palette keyed by PRN)
_CMAP = ("tab20", 20)


class PlotUI:
    def __init__(self, interactive: bool | None = None):
        import matplotlib
        if interactive is None:
            interactive = matplotlib.get_backend().lower() not in (
                "agg", "pdf", "svg", "ps", "template")
        import matplotlib.pyplot as plt
        self.plt = plt
        self.interactive = interactive
        self.fig = plt.figure(figsize=(11, 8))
        self.fig.canvas.manager.set_window_title("gps_sdr") \
            if getattr(self.fig.canvas, "manager", None) else None
        gs = self.fig.add_gridspec(2, 2)
        self.ax_table = self.fig.add_subplot(gs[0, 0])
        self.ax_stats = self.fig.add_subplot(gs[1, 0])
        self.ax_track = self.fig.add_subplot(gs[0, 1])
        self.ax_sky = self.fig.add_subplot(gs[1, 1], projection="polar")
        for ax in (self.ax_table, self.ax_stats):
            ax.axis("off")
        self._style_sky()
        self.ax_track.set_title("EN track")
        self.ax_track.set_aspect("equal", adjustable="datalim")

        self._events: list = []
        self._sat_rows: dict[int, dict] = {}
        self._track_en: list[tuple] = []
        self._ftrack_en: list[tuple] = []    # Kalman-filtered overlay
        self._origin = None          # (lat, lon) of first mean position
        self._mean_geo = None
        self._zoom_span = None       # manual EN half-span once zoomed
        self._widgets = {}
        self._init_buttons()
        if interactive:
            self.fig.canvas.mpl_connect("key_press_event", self._on_key)
            plt.ion()
            plt.show(block=False)

    # -- event surface (GpsUI.getEvents + initButtons,
    #    gpsui.py:193-250, 458-505) --

    def _init_buttons(self) -> None:
        """The reference's button bar (initButtons, gpsui.py:193-250):
        Sweep, Clear Stats & Track, Stop, Show on Map, Confine Height,
        an H= height entry, Close and track-zoom +/-.  Widgets work on
        Agg too; callbacks only append to the event queue."""
        from matplotlib.widgets import Button, CheckButtons, TextBox

        fig = self.fig

        def button(rect, label, cb):
            ax = fig.add_axes(rect)
            bt = Button(ax, label)
            bt.on_clicked(cb)
            return bt

        w = self._widgets
        w["sweep"] = button([0.10, 0.955, 0.10, 0.035], "Sweep",
                            self._on_bt_sweep)
        w["clear"] = button([0.42, 0.955, 0.17, 0.035],
                            "Clear Stats & Track", self._on_bt_clear)
        w["stop"] = button([0.74, 0.955, 0.10, 0.035], "Stop",
                           self._on_bt_stop)
        w["close"] = button([0.86, 0.955, 0.10, 0.035], "Close",
                            self._on_bt_close)
        w["map"] = button([0.86, 0.905, 0.10, 0.035], "Show on Map",
                          self._on_bt_map)
        ax_ch = fig.add_axes([0.02, 0.905, 0.14, 0.035])
        ax_ch.set_frame_on(False)
        w["conf_h"] = CheckButtons(ax_ch, ["Confine Height"], [False])
        w["conf_h"].on_clicked(self._on_conf_height)
        ax_h = fig.add_axes([0.22, 0.905, 0.07, 0.035])
        w["height"] = TextBox(ax_h, "H = ", initial="0",
                              textalignment="left")
        w["height"].on_submit(self._on_tb_height)
        w["zoom+"] = button([0.95, 0.52, 0.03, 0.035], "+",
                            self._on_zoom_plus)
        w["zoom-"] = button([0.95, 0.47, 0.03, 0.035], "-",
                            self._on_zoom_minus)

    def _on_bt_sweep(self, _ev=None):
        self._events.append("SWEEP")

    def _on_bt_stop(self, _ev=None):
        self._events.append("STOP")

    def _on_bt_close(self, _ev=None):
        self._events.append("CLOSE")

    def _on_bt_map(self, _ev=None):
        self._events.append("MAP")

    def _on_bt_clear(self, _ev=None):
        self._events.append("CLEAR")
        self._track_en = []
        self._ftrack_en = []
        self._origin = None
        self._zoom_span = None

    def _on_conf_height(self, _label=None):
        self._events.append("HEIGHT")

    def _on_tb_height(self, txt):
        """Height-value entry (onTbHeight, gpsui.py:493-498): a bad
        entry resets to 0, like the reference."""
        try:
            h = float(txt)
        except ValueError:
            h = 0.0
            self._widgets["height"].set_val("0")
        self._events.append(("SET_HEIGHT", h))

    def _zoom(self, factor: float) -> None:
        """Track-plot zoom (onZoomPlus/Minus, gpsui.py:500-505):
        + halves the EN span, - doubles it; Clear restores autoscale."""
        if self._track_en:
            arr = np.asarray(self._track_en)
            span = max(np.ptp(arr[:, 0]), np.ptp(arr[:, 1]), 1.0)
        else:
            span = 2.0
        if self._zoom_span is None:
            self._zoom_span = span / 2.0
        self._zoom_span *= factor
        self._apply_zoom()

    def _apply_zoom(self) -> None:
        if self._zoom_span is None:
            return
        c = (np.asarray(self._track_en[-1]) if self._track_en
             else np.zeros(2))
        s = self._zoom_span
        self.ax_track.set_xlim(c[0] - s, c[0] + s)
        self.ax_track.set_ylim(c[1] - s, c[1] + s)

    def _on_zoom_plus(self, _ev=None):
        self._zoom(0.5)

    def _on_zoom_minus(self, _ev=None):
        self._zoom(2.0)

    def _on_key(self, event) -> None:
        key = event.key or ""
        if key in ("s", "S"):
            self._on_bt_sweep()
        elif key in ("q", "Q"):
            self._on_bt_stop()
        elif key in ("m", "M"):
            self._on_bt_map()
        elif key in ("r", "R"):               # Clear (gpsui.py:193-250)
            self._on_bt_clear()
        elif key in ("h", "H"):               # ConfineHeight toggle
            self._on_conf_height()
        elif key == "+":
            self._on_zoom_plus()
        elif key == "-":
            self._on_zoom_minus()

    def get_events(self) -> list:
        ev, self._events = self._events, []
        return ev

    # -- panels --

    def _style_sky(self):
        self.ax_sky.set_theta_zero_location("N")
        self.ax_sky.set_theta_direction(-1)
        self.ax_sky.set_rlim(0, 90)
        self.ax_sky.set_rticks([0, 30, 60, 90])
        self.ax_sky.set_yticklabels(["90", "60", "30", "0"])
        self.ax_sky.set_title("satellites (azim/elev)")

    def _prn_color(self, prn: int):
        import matplotlib
        name, n = _CMAP
        return matplotlib.colormaps[name](prn % n)

    def update(self, epoch_frames: list, summary: dict, evaluator) -> None:
        """Reporter interface (same as HeadlessReporter.update)."""
        for sf in epoch_frames:
            sat = sf.get("SAT")
            if sat is None:
                continue
            row = self._sat_rows.setdefault(sat, {})
            row.update(amp=sf.get("AMP", 0.0), cor=sf.get("CRM", 0.0),
                       frq=sf.get("FRQ", 0.0), eph=sf.get("EPH", ""))
            if "CN0" in sf:
                row["cn0"] = 0.7 * row.get("cn0", sf["CN0"]) \
                    + 0.3 * sf["CN0"]
            if "tow" in sf:
                row.update(tow=sf["tow"], sfid=sf["ID"])

        used = summary.get("active_sats", set())
        self._draw_table(used, summary)
        self._draw_stats(summary)
        self._draw_track(summary)
        self._draw_sky(summary, used)
        if self.interactive:
            self.fig.canvas.draw_idle()
            self.fig.canvas.flush_events()

    def _draw_table(self, used, summary) -> None:
        ax = self.ax_table
        ax.clear()
        ax.axis("off")
        lines = ["PRN    AMP  C/N0    COR      FRQ      TOW ID EPH"]
        for sat in sorted(self._sat_rows):
            r = self._sat_rows[sat]
            mark = "*" if sat in used else " "
            lines.append(
                f"{mark}{sat:02d}  {r.get('amp', 0):5.1f} "
                f"{r.get('cn0', 0):5.1f} "
                f"{r.get('cor', 0):6.1f} {r.get('frq', 0):+8.1f} "
                f"{r.get('tow', 0):8d} {r.get('sfid', 0):2d} "
                f"{r.get('eph', ''):>3s}")
        t = summary.get("gps_time")
        title = f"t = {t}" if t else "waiting for time reference"
        ax.text(0.0, 1.0, "\n".join(lines), family="monospace",
                fontsize=8, va="top", transform=ax.transAxes)
        ax.set_title(title, fontsize=9)

    def _draw_stats(self, summary) -> None:
        ax = self.ax_stats
        ax.clear()
        ax.axis("off")
        stat = summary.get("stat")
        lines = []
        if stat is not None:
            mean, dev, n, n_out = stat
            lat, lon, alt = ecef_to_geo(mean)
            self._mean_geo = (lat, lon, alt)
            lines += [
                f"ECEF mean  ({mean[0]:12.1f}, {mean[1]:12.1f}, "
                f"{mean[2]:12.1f}) m",
                f"ECEF sd    ({dev[0]:6.2f}, {dev[1]:6.2f}, "
                f"{dev[2]:6.2f}) m   n={n}",
                f"geodetic   {lat:.6f} deg  {lon:.6f} deg  {alt:.1f} m",
                "",
            ]
        vel = summary.get("velocity")
        if vel is not None:
            lines += [
                f"speed      {float(np.linalg.norm(vel.vel)):5.2f} m/s"
                f"   clock drift {vel.clock_drift * 1e6:+.3f} ppm",
            ]
        dop = summary.get("dop")
        if dop is not None:
            lines += [f"DOP        G {dop[0]:.1f}  P {dop[1]:.1f}"
                      f"  H {dop[2]:.1f}  V {dop[3]:.1f}"]
        if vel is not None or dop is not None:
            lines += [""]
        lines += [
            f"skipped blocks : {summary.get('skipped_blocks', 0)}",
            f"outliers       : {summary.get('n_outliers', 0)}",
            f"LSF failures   : {summary.get('n_fails', 0)}",
            f"phase errors   : {summary.get('n_phase_errors', 0)}",
            "",
            "keys: [s]weep [r]eset [q]uit [m]ap [h]eight",
        ]
        ax.text(0.0, 1.0, "\n".join(lines), family="monospace",
                fontsize=8, va="top", transform=ax.transAxes)

    def _draw_track(self, summary) -> None:
        fixes = summary.get("fixes") or []
        for p in fixes:
            lat, lon, alt = ecef_to_geo(np.asarray(p[1:]))
            if self._origin is None:
                self._origin = (lat, lon)
            e, n = local_offsets_m((self._origin[0], self._origin[1], 0.0),
                                   (lat, lon, alt))
            self._track_en.append((float(e), float(n)))
        fp = summary.get("filtered_pos")
        if fp is not None and self._origin is not None:
            lat, lon, alt = ecef_to_geo(np.asarray(fp[1:4]))
            e, n = local_offsets_m((self._origin[0], self._origin[1],
                                    0.0), (lat, lon, alt))
            self._ftrack_en.append((float(e), float(n)))
        if not self._track_en:
            return
        ax = self.ax_track
        ax.clear()
        arr = np.asarray(self._track_en)
        ax.plot(arr[:, 0], arr[:, 1], "-", lw=0.7, color="0.6")
        if self._ftrack_en:
            fa = np.asarray(self._ftrack_en)
            ax.plot(fa[:, 0], fa[:, 1], "-", lw=1.2, color="tab:blue",
                    label="filtered")
            ax.legend(loc="upper right", fontsize=7)
        ax.plot(arr[-1:, 0], arr[-1:, 1], "o", color="red", ms=5)
        # km/m tick relabeling (gpsui.py:510-576 rescale semantics)
        span = max(np.ptp(arr[:, 0]), np.ptp(arr[:, 1]), 1.0)
        unit, div = ("km", 1000.0) if span > 2000 else ("m", 1.0)
        ax.set_xlabel(f"east [{unit}]")
        ax.set_ylabel(f"north [{unit}]")
        if div != 1.0:
            from matplotlib.ticker import FuncFormatter
            fmt = FuncFormatter(lambda v, _: f"{v / div:g}")
            ax.xaxis.set_major_formatter(fmt)
            ax.yaxis.set_major_formatter(fmt)
        ax.set_title("EN track")
        ax.set_aspect("equal", adjustable="datalim")
        self._apply_zoom()                    # manual zoom sticks

    def _draw_sky(self, summary, used) -> None:
        sat_pos = summary.get("sat_positions") or []
        if not sat_pos or self._mean_geo is None:
            return
        ax = self.ax_sky
        ax.clear()
        self._style_sky()
        from gps_sdr.utils.geodesy import geo_to_ecef
        rec = np.asarray(geo_to_ecef(*self._mean_geo))
        for sat, pos in sat_pos:
            elev, azim = ecef_to_azim_elev(rec, np.asarray(pos))
            r = 90.0 - elev
            th = np.radians(azim)
            ax.plot([th], [r], "o", color=self._prn_color(sat), ms=6)
            ax.annotate(str(sat), (th, r), fontsize=7,
                        textcoords="offset points", xytext=(4, 4))

    # -- export --

    def save_map(self, path: str) -> str | None:
        if self._mean_geo is None:
            return None
        from gps_sdr.ui.webmap import save_map
        if self._origin is not None and self._track_en:
            lat0, lon0 = self._origin
            # EN offsets back to lat/lon for the polyline
            track = []
            for e, n in self._track_en:
                dlat = np.degrees(n / 6_371_000.0)
                dlon = np.degrees(
                    e / (6_371_000.0 * np.cos(np.radians(lat0))))
                track.append((lat0 + dlat, lon0 + dlon))
        else:
            track = []
        return save_map(path, self._mean_geo, track)

    def savefig(self, path: str) -> None:
        self.fig.savefig(path, dpi=110)

    def close(self) -> None:
        self.plt.close(self.fig)
