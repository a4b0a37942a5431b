"""Two-process deployment: the evaluator half as a real subprocess fed
over UDP (the reference's SEND_OVER_UDP topology, gpssdr.py +
gpsglob.py:79-88), receiver side driven by the transport sender."""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from gps_sdr.config import DEFAULT as CFG
from gps_sdr.runtime.evaluator import EpochInput
from gps_sdr.runtime.transport import DATA_PORT, EpochSender
from tests.test_cli_ui import epoch_records  # fixture  # noqa: F401


def _wait_until_bound(proc, port: int, timeout: float = 90.0) -> None:
    """Poll until the subprocess has bound the UDP data port (a fresh
    bind attempt then fails with EADDRINUSE) instead of sleeping a
    fixed time — robust on an arbitrarily loaded host."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if proc.poll() is not None:
            raise AssertionError(
                f"eval process exited early: {proc.stdout.read()}")
        probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            probe.bind(("", port))
        except OSError:
            return                      # port taken -> receiver is up
        finally:
            probe.close()
        time.sleep(0.25)
    raise AssertionError(f"eval process never bound port {port}")


def test_eval_subprocess_over_udp(tmp_path, epoch_records):  # noqa: F811
    scn, records = epoch_records
    out = tmp_path / "udp_run"
    proc = subprocess.Popen(
        [sys.executable, "-m", "gps_sdr", "eval", "--ui", "none",
         "--out", str(out), "--max-sec", "20"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        _wait_until_bound(proc, DATA_PORT)
        tx = EpochSender()
        for rec in records:
            tx.send(EpochInput(*rec))
            time.sleep(0.05)                  # don't overrun the socket
        tx.close()
        # idle timeout in run_eval_process ends the loop
        code = proc.wait(timeout=120)
        assert code == 0, proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
    pos = json.loads((tmp_path / "udp_run_gpsPos.json").read_text())
    assert len(pos) > 100
    mean = np.mean(np.asarray(pos)[:, 1:], axis=0)
    assert np.linalg.norm(mean - scn.rec_ecef) < 5.0


def test_eval_role_never_imports_jax():
    """The evaluator half of the two-process topology runs on the host
    only: it must not import JAX (so it cannot open the card a second
    time beside the receiver process)."""
    prog = ("import sys\n"
            "from gps_sdr.cli import build_parser, make_config, "
            "run_eval_process\n"
            "import gps_sdr.runtime.evaluator, gps_sdr.runtime.transport\n"
            "import gps_sdr.utils.io, gps_sdr.ui.headless\n"
            "assert 'jax' not in sys.modules, 'eval role imported jax'\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", prog], check=True, timeout=120,
                   cwd=repo, env=dict(os.environ, PYTHONPATH=repo))
