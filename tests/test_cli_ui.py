"""CLI launcher, UDP transport, plot UI and map export smoke tests."""

import json
import os
import pickle

import numpy as np
import pytest

import matplotlib

matplotlib.use("Agg")

from gps_sdr.config import DEFAULT as CFG
from gps_sdr.models.scenario import make_scenario
from gps_sdr.runtime.evaluator import EpochInput
from gps_sdr.runtime.transport import (EpochReceiver, EpochSender,
                                       _split_epoch)
from gps_sdr.utils import io
from tests.test_pipeline import ideal_measurements


@pytest.fixture(scope="module")
def epoch_records():
    scn = make_scenario(CFG, n_sats=6, duration_sec=40.0, seed=3)
    coph, frames = ideal_measurements(scn, 36)
    records = []
    for sec in range(36):
        lo, hi = sec * CFG.no_sec + 1, (sec + 1) * CFG.no_sec + 1
        sec_frames, sec_coph = [], {}
        for sat in scn.sats:
            sec_frames += [dict(sf) for st, sf in frames[sat.prn]
                           if lo * CFG.ngps <= st + 6 * CFG.sample_rate
                           < hi * CFG.ngps]
            sec_coph[sat.prn] = [(sno, cp) for sno, cp in coph[sat.prn]
                                 if lo <= sno < hi]
        records.append((0, sec_frames, sec_coph))
    return scn, records


def test_cli_epochs_replay(tmp_path, epoch_records):
    scn, records = epoch_records
    rec_path = tmp_path / "epochs.pickle"
    io.save_epoch_records(str(rec_path), records)

    from gps_sdr.cli import main
    out = tmp_path / "run"
    rc = main(["epochs", str(rec_path), "--ui", "none",
               "--out", str(out), "--save-track", "--save-map"])
    assert rc == 0
    pos = json.loads((tmp_path / "run_gpsPos.json").read_text())
    assert len(pos) > 100
    mean = np.mean(np.asarray(pos)[:, 1:], axis=0)
    assert np.linalg.norm(mean - scn.rec_ecef) < 5.0
    assert (tmp_path / "run_track.gpx").exists()
    assert (tmp_path / "run_map.html").exists()
    assert "leaflet" in (tmp_path / "run_map.html").read_text()


def test_cli_ephem_cache_roundtrip(tmp_path, epoch_records):
    scn, records = epoch_records
    rec_path = tmp_path / "epochs.pickle"
    io.save_epoch_records(str(rec_path), records)
    cache = tmp_path / "eph.json"

    from gps_sdr.cli import main
    assert main(["epochs", str(rec_path), "--ui", "none",
                 "--ephem-cache", str(cache)]) == 0
    loaded = io.load_ephemerides(str(cache))
    assert set(loaded) == {s.prn for s in scn.sats}
    for s in scn.sats:
        assert np.isclose(loaded[s.prn]["sqrtA"], s.eph["sqrtA"])


def test_transport_roundtrip(epoch_records):
    _, records = epoch_records
    epoch = EpochInput(*records[20])
    tx = EpochSender(data_port=52431, ctrl_port=52432)
    rx = EpochReceiver(data_port=52431, ctrl_port=52432)
    try:
        n = tx.send(epoch)
        got = []
        for _ in range(n):
            e = rx.recv()
            assert e is not None
            got.append(e)
        assert rx.recv() is None
        merged_frames = sum((e.frames for e in got), [])
        assert merged_frames == epoch.frames
        merged_cp = {}
        for e in got:
            for k, v in e.code_phases.items():
                merged_cp.setdefault(k, []).extend(v)
        assert merged_cp == epoch.code_phases
        rx.request_sweep()
        import time
        time.sleep(0.05)
        assert tx.poll_command() == "SWEEP"
    finally:
        tx.close()
        rx.close()


def test_transport_split_large_epoch():
    coph = {prn: [(i, float(i % 2048)) for i in range(4000)]
            for prn in (2, 3, 4)}
    epoch = EpochInput(5, [{"SAT": 2, "ID": 1}], coph)
    parts = list(_split_epoch(epoch))
    assert len(parts) > 1
    for p in parts:
        assert len(pickle.dumps(
            (p.skipped_samples, p.frames, p.code_phases))) <= 65_504
    # merged content identical
    total = sum(len(v) for p in parts for v in p.code_phases.values())
    assert total == 12000
    assert sum(p.skipped_samples for p in parts) == 5


def test_plot_ui_renders(tmp_path, epoch_records):
    scn, records = epoch_records
    from gps_sdr.runtime.evaluator import Evaluator
    from gps_sdr.ui.plot import PlotUI

    ev = Evaluator(CFG)
    ui = PlotUI(interactive=False)
    for rec in records:
        epoch = EpochInput(*rec)
        summary = ev.process(epoch)
        ui.update(epoch.frames, summary, ev)
    png = tmp_path / "ui.png"
    ui.savefig(str(png))
    assert png.stat().st_size > 10_000
    html = ui.save_map(str(tmp_path / "m.html"))
    assert html and os.path.exists(html)
    ui.close()


def test_cli_solve_clock_rate_flag():
    """--solve-clock-rate must reach ReceiverConfig (the reference's
    SDR_FREQCORR replacement, gpsglob.py:30 / README.md:204-217)."""
    from gps_sdr.cli import build_parser, make_config

    ap = build_parser()
    args = ap.parse_args(["synth", "--solve-clock-rate"])
    assert make_config(args).solve_clock_rate is True
    args = ap.parse_args(["synth"])
    assert make_config(args).solve_clock_rate is False
