"""CLI run-mode smokes: the replay and synth subcommands end-to-end
(subprocess, tiny workloads — fix production needs ~30 s of signal and
is covered by examples/synthetic_fix.py and the epochs-mode test)."""

import subprocess
import sys

import numpy as np

from gps_sdr.config import ReceiverConfig
from gps_sdr.models.simulator import SatSignal, random_bits, synth_stream
from gps_sdr.runtime.sources import pack_iq
from tests.conftest import cached_synth


def _run(args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "gps_sdr", *args],
        capture_output=True, text=True, timeout=timeout,
        env={"PATH": "/usr/bin:/bin", "HOME": "/root",
             "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": "."},
        cwd="/root/repo")


def test_cli_replay_capture(tmp_path):
    cfg = ReceiverConfig()
    sat = SatSignal(prn=9, doppler=1500.0, code_delay=100.0,
                    nav_bits=random_bits(64, seed=1))
    blocks = 0.25 * cached_synth("recovery_skip_v1", lambda: synth_stream(
        cfg, [sat], n_blocks=3 * cfg.no_sec + 1, noise_std=0.4))
    cap = tmp_path / "cap.bin"
    with open(cap, "wb") as f:
        for b in blocks:
            pack_iq(b).tofile(f)

    r = _run(["replay", str(cap), "--ui", "headless",
              "--out", str(tmp_path / "r")])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "processed" in r.stdout
    # the lone satellite acquired and appears in the status table
    assert "09" in r.stdout
    assert "no position fix" in r.stdout  # 3 s: no ephemeris yet


def test_cli_synth_mode(tmp_path):
    r = _run(["synth", "--sec", "2.1", "--sats", "2", "--seed", "2",
              "--ui", "none", "--record-epochs",
              str(tmp_path / "rec.pickle")], timeout=420)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "no position fix" in r.stdout
    from gps_sdr.utils.io import load_epoch_records
    recs = load_epoch_records(str(tmp_path / "rec.pickle"))
    assert len(recs) >= 2
    # epochs carry code phases for the synthesized satellites
    sats_seen = set()
    for _, frames, coph in recs:
        sats_seen |= set(coph)
    assert len(sats_seen) == 2


def test_cli_serve_mode(tmp_path):
    """serve subcommand: S synthetic replica streams through
    StreamServer with a checkpoint at exit, then a resume run (the
    resumed server skips the cold sweep and continues tracking)."""
    ck = str(tmp_path / "srv.pkl")
    r = _run(["serve", "synth", "--streams", "2", "--sec", "4",
              "--sats", "2", "--seed", "2", "--windows", "2",
              "--save-state", ck], timeout=420)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "2 streams x" in r.stdout
    assert "checkpointed 2 streams" in r.stdout
    r2 = _run(["serve", "synth", "--streams", "2", "--sec", "4",
               "--sats", "2", "--seed", "2", "--windows", "2",
               "--resume-state", ck], timeout=420)
    assert r2.returncode == 0, r2.stdout + r2.stderr
    assert "stream 1:" in r2.stdout
