"""chip_smoke.py on the CPU: it must refuse to run without a GPU, and its
phase functions must pass when called directly at a small geometry
(product code length, few channels, short runs with an ephemeris cache
so a fix comes within 20 s)."""

import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke
from gps_sdr.config import ReceiverConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_gpu():
    r = _run_smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_exits_nonzero_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(tmp_path, str(tmp_path / "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_phase_device_requires_gpu():
    info = chip_smoke.phase_device(require_gpu=False)
    assert info["platform"] == "cpu" and info["count"] >= 1
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.phase_device(require_gpu=True)


def test_phase_build_loads_native_libraries():
    assert chip_smoke.phase_build() == {"evalcore": True, "navscan": True,
                                        "ingest": True}


def test_phase_kernels_small():
    out = chip_smoke.phase_kernels(ReceiverConfig(max_sat=4), n_channels=4,
                                   n_sats=6, n_blocks=128)
    assert len(out["acquired"]) >= 4


def test_phase_closed_loop_small():
    # a 20 s run averages a few seconds of fixes: looser than 8 m
    out = chip_smoke.phase_closed_loop(ReceiverConfig(max_sat=6), sec=20.0,
                                       n_sats=6, max_err_m=25.0,
                                       preload_ephemeris=True)
    assert out["fixes"] > 0


def test_phase_serving_small():
    out = chip_smoke.phase_serving(ReceiverConfig(max_sat=6), n_streams=2,
                                   sec=20.0, n_sats=6, max_err_m=25.0)
    assert len(out["positions"]) == 2
    assert all(len(p) > 0 for p in out["positions"])
