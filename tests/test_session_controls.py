"""Session control surface: UI events -> receiver; ephemeris cache age
gating (the reference's GUI command path and 2 h warm-start rule)."""

import json
import time

import numpy as np

from gps_sdr.config import ReceiverConfig
from gps_sdr.models.simulator import SatSignal, random_bits, synth_stream
from gps_sdr.runtime.session import Session
from gps_sdr.utils import io
from tests.conftest import cached_synth


class FakeUI:
    """Reporter emitting a STOP event after the second epoch."""

    def __init__(self):
        self.n = 0

    def update(self, frames, summary, ev):
        self.n += 1

    def get_events(self):
        return ["STOP"] if self.n == 2 else []


def test_ui_stop_event_halts_receiver():
    cfg = ReceiverConfig()
    sat = SatSignal(prn=9, doppler=1500.0, code_delay=100.0,
                    nav_bits=random_bits(64, seed=1))
    blocks = cached_synth("recovery_skip_v1", lambda: synth_stream(
        cfg, [sat], n_blocks=3 * cfg.no_sec + 1, noise_std=0.4))
    ui = FakeUI()
    s = Session(cfg, reporter=ui)
    s.run_source(iter(blocks))
    # 3 chunks available, but STOP after epoch 2 ends the run
    assert ui.n == 2
    assert s.receiver._stop


class EventOnceUI:
    def __init__(self, event):
        self.event = event
        self.n = 0

    def update(self, frames, summary, ev):
        self.n += 1

    def get_events(self):
        return [self.event] if self.n == 1 else []


def test_ui_clear_and_height_events():
    cfg = ReceiverConfig()
    sat = SatSignal(prn=9, doppler=1500.0, code_delay=100.0,
                    nav_bits=random_bits(64, seed=1))
    blocks = cached_synth("recovery_skip_v1", lambda: synth_stream(
        cfg, [sat], n_blocks=3 * cfg.no_sec + 1, noise_std=0.4))
    s = Session(cfg, reporter=EventOnceUI("HEIGHT"))
    s.run_source(iter(blocks))
    assert s.evaluator.cfg.conf_height  # toggled from default False

    s2 = Session(cfg, reporter=EventOnceUI("CLEAR"))
    s2.evaluator.positions = [[0, 1, 2, 3]]
    s2.evaluator.stat = (np.zeros(3), np.zeros(3), 1, 0)
    s2.run_source(iter(blocks))
    # cleared after the first epoch; no fixes follow (no ephemerides)
    assert s2.evaluator.positions == []
    assert s2.evaluator.stat is None


def _blocks():
    cfg = ReceiverConfig()
    sat = SatSignal(prn=9, doppler=1500.0, code_delay=100.0,
                    nav_bits=random_bits(64, seed=1))
    return cfg, cached_synth("recovery_skip_v1", lambda: synth_stream(
        cfg, [sat], n_blocks=3 * cfg.no_sec + 1, noise_std=0.4))


def test_ui_close_event_stops_and_closes():
    cfg, blocks = _blocks()

    class ClosableUI(EventOnceUI):
        closed = False

        def close(self):
            self.closed = True

    ui = ClosableUI("CLOSE")
    s = Session(cfg, reporter=ui)
    s.run_source(iter(blocks))
    assert s.receiver._stop and ui.closed


def test_ui_set_height_event():
    cfg, blocks = _blocks()
    s = Session(cfg, reporter=EventOnceUI(("SET_HEIGHT", 123.0)))
    s.run_source(iter(blocks))
    assert s.evaluator.cfg.height == 123.0


def test_plotui_buttons_emit_reference_events():
    """Every reference control (initButtons, gpsui.py:193-250) must
    emit its event through the PlotUI queue; zoom must clamp the track
    axes."""
    import matplotlib
    matplotlib.use("Agg", force=True)
    from gps_sdr.ui.plot import PlotUI

    ui = PlotUI(interactive=False)
    try:
        ui._on_bt_sweep()
        ui._on_bt_clear()
        ui._on_bt_stop()
        ui._on_bt_map()
        ui._on_bt_close()
        ui._on_conf_height()
        ui._on_tb_height("250")
        assert ui.get_events() == ["SWEEP", "CLEAR", "STOP", "MAP",
                                   "CLOSE", "HEIGHT",
                                   ("SET_HEIGHT", 250.0)]
        # malformed height entry resets to 0 like the reference
        ui._on_tb_height("abc")
        assert ui.get_events() == [("SET_HEIGHT", 0.0)]
        # zoom halves / doubles the EN span around the newest point
        ui._track_en = [(0.0, 0.0), (100.0, 50.0)]
        ui._on_zoom_plus()
        x0 = np.diff(ui.ax_track.get_xlim())[0]
        ui._on_zoom_minus()
        ui._on_zoom_minus()
        assert np.isclose(np.diff(ui.ax_track.get_xlim())[0], 4 * x0)
        # keyboard aliases drive the same handlers
        class K:
            key = "+"
        ui._on_key(K())
        assert ui._zoom_span is not None
    finally:
        ui.close()


def test_ephemeris_cache_age_gating(tmp_path):
    path = tmp_path / "eph.json"
    io.save_ephemerides(str(path), {7: {"IODC": 5, "sqrtA": 5153.6}})
    fresh = io.load_ephemerides(str(path))
    assert 7 in fresh and fresh[7]["sqrtA"] == 5153.6
    # backdate the stamp beyond the 2 h validity (gpseval.py:97-99)
    doc = json.loads(path.read_text())
    doc["POSIX-Time"] = int(time.time()) - 3 * 3600
    path.write_text(json.dumps(doc))
    assert io.load_ephemerides(str(path)) == {}
