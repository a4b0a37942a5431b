"""Snapshot (coarse-time) positioning: fix from one block, no decode.

Beyond-reference capability (the reference needs ~30 s of decoded nav
data before its first fix, src/gpseval.py:181-232); verified against
the scenario simulator's geometric truth.
"""

import numpy as np

from gps_sdr.config import DEFAULT as CFG
from gps_sdr.models.scenario import make_scenario, synth_scenario_blocks
from gps_sdr.ops import cacode
from gps_sdr.ops.snapshot import snapshot_fix, solve_snapshot

from conftest import cached_synth


def _truth_fracs(scn, t_rx):
    """Fractional code phases (ms) of every scenario satellite at
    receiver GPS time t_rx — the exact-measurement oracle: code-period
    starts are integer ms of SV clock time tau_sv = t - tau + dtsv."""
    fracs, ephs = [], []
    for sat in scn.sats:
        _, tau_sv = scn.sat_states(np.array([t_rx]), sat)
        fracs.append((-tau_sv[0] * 1000.0) % 1.0)
        ephs.append(sat.eph)
    return np.array(fracs), ephs


def test_snapshot_solver_exact():
    scn = make_scenario(CFG, n_sats=7, duration_sec=1.0, seed=11)
    t_rx = scn.t_rx0 + 0.5
    fracs, ephs = _truth_fracs(scn, t_rx)

    prior = scn.rec_ecef + np.array([30e3, -30e3, 20e3])   # ~47 km off
    res = solve_snapshot(ephs, fracs, t_rx - 25.0, prior)
    assert res is not None
    err = np.linalg.norm(res.rec_pos - scn.rec_ecef)
    assert err < 5.0, err
    assert abs(res.t_gps - t_rx) < 0.05
    assert res.residual_m < 1.0


def test_snapshot_solver_far_prior():
    """Integer rollover resolution holds out to ~120 km / 50 s priors."""
    scn = make_scenario(CFG, n_sats=8, duration_sec=1.0, seed=5)
    t_rx = scn.t_rx0 + 0.5
    fracs, ephs = _truth_fracs(scn, t_rx)

    prior = scn.rec_ecef + np.array([-80e3, 60e3, -50e3])  # ~112 km off
    res = solve_snapshot(ephs, fracs, t_rx + 50.0, prior)
    assert res is not None
    err = np.linalg.norm(res.rec_pos - scn.rec_ecef)
    assert err < 10.0, err


def test_snapshot_underdetermined():
    scn = make_scenario(CFG, n_sats=4, duration_sec=1.0, seed=2)
    t_rx = scn.t_rx0 + 0.5
    fracs, ephs = _truth_fracs(scn, t_rx)
    assert solve_snapshot(ephs, fracs, t_rx, scn.rec_ecef) is None
    # ...but the WGS84 height constraint makes 4 satellites solvable
    res = solve_snapshot(ephs, fracs, t_rx - 10.0,
                         scn.rec_ecef + np.array([20e3, -10e3, 5e3]),
                         height=scn.rec_geo[2])
    assert res is not None
    assert np.linalg.norm(res.rec_pos - scn.rec_ecef) < 30.0


def test_snapshot_end_to_end():
    """IQ block -> acquisition -> snapshot fix, coarse prior only."""
    scn = make_scenario(CFG, n_sats=7, duration_sec=4.0, seed=11)
    first_block = 8
    block = cached_synth(
        "snapshot_e2e_v1",
        lambda: synth_scenario_blocks(scn, first_block, 1, noise_std=0.6,
                                      seed=7))[0]
    t_rx = scn.t_rx0 + first_block * CFG.ngps / CFG.sample_rate
    ephs_by_prn = {sat.prn: sat.eph for sat in scn.sats}
    prior = scn.rec_ecef + np.array([30e3, -30e3, 20e3])

    res = snapshot_fix(CFG, block, cacode.ca_fft_table(CFG), ephs_by_prn,
                       t_rx - 20.0, prior)
    assert res is not None
    assert res.n_sat >= 5
    err = np.linalg.norm(res.rec_pos - scn.rec_ecef)
    assert err < 50.0, err          # measured: 11.7 m from one block
    assert abs(res.t_gps - t_rx) < 0.01


def test_snapshot_cli(tmp_path, capsys):
    """`python -m gps_sdr snapshot` on an 8-bit capture + cached
    ephemerides + coarse geo/time prior."""
    import re

    from gps_sdr import cli
    from gps_sdr.runtime.sources import pack_iq
    from gps_sdr.utils.io import save_ephemerides

    scn = make_scenario(CFG, n_sats=7, duration_sec=4.0, seed=11)
    first_block = 8
    block = cached_synth(
        "snapshot_e2e_v1",
        lambda: synth_scenario_blocks(scn, first_block, 1, noise_std=0.6,
                                      seed=7))[0]
    cap = tmp_path / "cap.bin"
    with open(cap, "wb") as f:
        pack_iq(block).tofile(f)
    eph_path = tmp_path / "eph.json"
    save_ephemerides(str(eph_path), {s.prn: s.eph for s in scn.sats})
    t_rx = scn.t_rx0 + first_block * CFG.ngps / CFG.sample_rate
    lat, lon, h = scn.rec_geo

    rc = cli.main(["snapshot", str(cap),
                   "--ephem-cache", str(eph_path),
                   "--prior-geo", f"{lat + 0.3},{lon - 0.3},{h}",
                   "--tow", str(t_rx - 20.0)])
    assert rc == 0
    out = capsys.readouterr().out
    m = re.search(r"snapshot fix: ([-\d.]+) deg, ([-\d.]+) deg", out)
    assert m, out
    assert abs(float(m.group(1)) - lat) < 0.002       # ~200 m
    assert abs(float(m.group(2)) - lon) < 0.003
