"""Differential validation against the ACTUAL reference implementation.

Every parity claim in this repo was previously checked against oracles
written by the same author — a shared misunderstanding would cancel out.
This module closes that loop: the upstream sources at /root/reference/src
are imported and EXECUTED (never copied — see tests/ref_driver.py) on a
synthetic 8-bit capture, and their outputs are compared field-by-field
with this repo's pipeline on the same bytes:

  * acquisition : same PRN set (gpsrecv.sweepAllSats vs ops/acquisition)
  * tracking    : interpolated code phases agree to a fraction of a
                  sample (gpslib.SatStream.process vs ops/tracking)
  * nav decode  : decoded subframe dicts are IDENTICAL field-for-field
                  (gpslib.Subframe vs models/navmsg)
  * positioning : fix trajectories agree within the reference's own
                  1-5 m scatter (gpseval pipeline + leastSquaresPos vs
                  runtime/evaluator + ops/pvt)

The capture is mild-TCXO (0.3 ppm) so every Doppler falls inside the
reference's hard-coded +-5 kHz sweep (gpsglob.py:73-75).  Both the
capture and the reference run are disk-cached; steady-state CI cost is
one extra Session replay.
"""

import os

import numpy as np
import pytest

from gps_sdr.config import ReceiverConfig
from gps_sdr.models.scenario import make_scenario
from gps_sdr.models.scenario_jax import DeviceScenarioSynth
from gps_sdr.runtime.sources import pack_iq, replay_blocks
from tests.conftest import _SYNTH_CACHE, reference_result

SEC = 48.0
SEED = 2                  # GDOP 2.26 at the golden coordinates
OSC_PPM = 0.3             # keeps Dopplers inside the reference's +-5 kHz
OSC_PPM_RATE = 1.0e-4
NOISE_STD = 1.0           # ~9-25 sigma correlations: realistic, and cross-
                          # correlation floor stays below the 8 sigma gate
SCALE = 0.05

CFG = ReceiverConfig()

# reference transport keys added by reportValues (gpslib.py:1124-1131)
# and the eval loop — everything else in a subframe dict is a nav field
# and must match exactly
TRANSPORT_KEYS = {"SAT", "AMP", "CRM", "FRQ", "SWP", "EPH", "ST"}


def _scenario():
    return make_scenario(CFG, n_sats=8, duration_sec=SEC + 12.0, seed=SEED,
                         osc_ppm=OSC_PPM, osc_ppm_rate=OSC_PPM_RATE)


def _capture_path():
    os.makedirs(_SYNTH_CACHE, exist_ok=True)
    path = os.path.join(_SYNTH_CACHE, "diff_capture_v1.bin")
    if os.path.exists(path):
        return path
    scn = _scenario()
    dev = DeviceScenarioSynth(scn, noise_std=NOISE_STD)
    n_blocks = int(round(SEC / CFG.block_sec))
    step = CFG.no_sec
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        done = 0
        while done < n_blocks:
            k = min(step, n_blocks - done)
            chunk = np.asarray(dev.chunk(done, k))
            pack_iq(SCALE * chunk).tofile(f)
            done += k
    os.replace(tmp, path)
    return path


@pytest.fixture(scope="module")
def ref_result():
    """Run the reference pipeline (subprocess; see ref_driver.py) once
    per capture; cache the pickled outputs."""
    return reference_result("diff_refresult_v1.pkl", _capture_path)


@pytest.fixture(scope="module")
def ours():
    """This repo's pipeline on the same capture."""
    from gps_sdr.runtime.session import Session

    path = _capture_path()
    session = Session(CFG, record_epochs_to="memory")
    summary = session.run_source(replay_blocks(path, CFG))
    return session, summary


def test_acquired_prn_sets_match(ref_result, ours):
    session, _ = ours
    scn = _scenario()
    true_prns = {s.prn for s in scn.sats}
    ref_prns = {s for _, s, _, _ in ref_result["found"]}
    our_prns = {int(p) for p in session.receiver.slots.slot_prn if p != 0}
    assert ref_prns == true_prns
    assert our_prns == ref_prns


def test_decoded_subframes_identical(ref_result, ours):
    """Every nav field of every subframe both sides decoded must agree
    exactly — this is the claim the shared encoder/decoder table could
    have silently broken."""
    session, _ = ours
    ref_frames = {}
    for sf in ref_result["frames"]:
        ref_frames[(sf["SAT"], sf["ID"], sf["tow"])] = sf

    our_frames = {}
    for rec in session.records:
        for sf in rec[1]:
            if "ID" in sf:
                our_frames[(sf["SAT"], sf["ID"], sf["tow"])] = sf

    common = set(ref_frames) & set(our_frames)
    # both sides must have decoded a healthy stream of subframes, and
    # they must overlap almost completely
    assert len(ref_frames) >= 30, f"reference decoded {len(ref_frames)}"
    assert len(common) >= 0.9 * len(ref_frames), (
        f"only {len(common)}/{len(ref_frames)} subframes in common; "
        f"ours={len(our_frames)}")

    mismatches = []
    for key in sorted(common):
        rf, of = ref_frames[key], our_frames[key]
        nav_keys = (set(rf) & set(of)) - TRANSPORT_KEYS
        # our decoder must not be missing any reference nav field
        missing = set(rf) - TRANSPORT_KEYS - set(of)
        assert not missing, f"{key}: fields absent in ours: {missing}"
        for k in nav_keys:
            if rf[k] != of[k]:
                mismatches.append((key, k, rf[k], of[k]))
        # sample-time anchor of the subframe (preamble start)
        if abs(int(rf["ST"]) - int(of["ST"])) > 3:
            mismatches.append((key, "ST", rf["ST"], of["ST"]))
    assert not mismatches, f"{len(mismatches)} field mismatches: " \
                           f"{mismatches[:10]}"


def test_code_phases_subsample_agreement(ref_result, ours):
    session, _ = ours
    our_coph = {}
    for rec in session.records:
        for sat, lst in rec[2].items():
            our_coph.setdefault(sat, {}).update(
                {int(n): float(cp) for n, cp in lst})

    cs = CFG.code_samples
    n_pairs = 0
    deltas = []
    for sat, ref_lst in ref_result["coph"].items():
        mine = our_coph.get(sat, {})
        for stream_no, ref_cp in ref_lst:
            if stream_no in mine:
                d = (mine[stream_no] - ref_cp + cs / 2) % cs - cs / 2
                deltas.append(d)
                n_pairs += 1
    deltas = np.abs(np.array(deltas))
    assert n_pairs >= 1000, f"only {n_pairs} comparable code phases"
    med = float(np.median(deltas))
    p99 = float(np.percentile(deltas, 99))
    assert med < 0.15, f"median |dcp| {med:.3f} samples"
    assert p99 < 0.5, f"p99 |dcp| {p99:.3f} samples"


def test_fix_trajectories_agree(ref_result, ours):
    session, _ = ours
    scn = _scenario()
    truth = scn.rec_ecef

    ref_fixes = np.array(ref_result["fixes"], dtype=np.float64)
    our_fixes = np.array([[p[0], p[1], p[2], p[3]]
                          for p in session.evaluator.positions],
                         dtype=np.float64)
    assert len(ref_fixes) >= 100, f"reference produced {len(ref_fixes)} fixes"
    assert len(our_fixes) >= 100, f"we produced {len(our_fixes)} fixes"

    # absolute accuracy: both pipelines see the same capture-inherent
    # scatter/bias (measured ~9.5 m mean for BOTH at this noise level
    # and no carrier smoothing) — the differential claim below is the
    # tight one
    ref_err = np.linalg.norm(ref_fixes[:, 1:4] - truth, axis=1)
    our_err = np.linalg.norm(our_fixes[:, 1:4] - truth, axis=1)
    assert np.mean(ref_err) < 12.0, f"ref mean err {np.mean(ref_err):.2f}"
    assert np.mean(our_err) < 12.0, f"our mean err {np.mean(our_err):.2f}"
    assert np.mean(our_err) < np.mean(ref_err) + 1.0, (
        "we are materially less accurate than the reference: "
        f"{np.mean(our_err):.2f} vs {np.mean(ref_err):.2f} m")

    # join epochs on the fix timestamp (both sides stamp POSIX seconds
    # at N_CYC-ms granularity); measured: 735/736 common, median
    # separation 0.13 m, p95 0.78 m, mean-position gap 0.20 m
    ref_by_t = {round(t, 3): xyz for t, *xyz in ref_fixes}
    our_by_t = {round(t, 3): xyz for t, *xyz in our_fixes}
    common = sorted(set(ref_by_t) & set(our_by_t))
    assert len(common) >= 0.9 * len(ref_by_t), (
        f"only {len(common)} common epochs of {len(ref_by_t)}")
    d = np.array([np.linalg.norm(np.subtract(ref_by_t[t], our_by_t[t]))
                  for t in common])
    assert np.median(d) < 1.0, f"median epoch separation {np.median(d):.2f} m"
    assert np.percentile(d, 95) < 3.0, f"p95 separation " \
                                       f"{np.percentile(d, 95):.2f} m"
    assert np.linalg.norm(np.mean(ref_fixes[:, 1:4], axis=0)
                          - np.mean(our_fixes[:, 1:4], axis=0)) < 1.0


@pytest.fixture(scope="module")
def ours_device(ref_result):
    """The same capture through the DEVICE product path — run_device
    with fused window dispatch + sparse window consume (throughput
    mode, CPU backend).  The host-path fixture validates the
    algorithms; this one differentially validates the windowed
    device-loop machinery (track_window, unpack_window_compact,
    _consume_window_compact) against the executed reference."""
    import functools

    import jax
    import jax.numpy as jnp

    from gps_sdr.ops.tracking import to_grouped_planar
    from gps_sdr.runtime.session import Session

    path = _capture_path()
    blocks = np.stack(list(replay_blocks(path, CFG)))
    cfg = CFG.replace(chunks_per_download=8,
                      download_windows_in_flight=2,
                      defer_subframe_poll=True,
                      epoch_per_window=True)
    buf = jnp.asarray(to_grouped_planar(cfg, blocks))
    t = cfg.no_sec
    n_chunks = blocks.shape[0] // t

    @functools.partial(jax.jit, static_argnums=2)
    def _slice(b, first, n):
        return jax.lax.dynamic_slice_in_dim(b, first, n)

    session = Session(cfg, record_epochs_to="memory")
    session.run_device_source(
        lambda first, n: _slice(buf, jnp.int32(first), n), n_chunks)
    return session


def test_device_path_subframes_identical(ref_result, ours_device):
    """The fused windowed device loop must decode the same subframes,
    field-for-field, as the executed reference."""
    session = ours_device
    ref_frames = {}
    for sf in ref_result["frames"]:
        ref_frames[(sf["SAT"], sf["ID"], sf["tow"])] = sf
    our_frames = {}
    for rec in session.records:
        for sf in rec[1]:
            if "ID" in sf:
                our_frames[(sf["SAT"], sf["ID"], sf["tow"])] = sf
    common = set(ref_frames) & set(our_frames)
    assert len(ref_frames) >= 30
    assert len(common) >= 0.9 * len(ref_frames), (
        f"only {len(common)}/{len(ref_frames)} subframes in common; "
        f"ours={len(our_frames)}")
    mismatches = []
    for key in sorted(common):
        rf, of = ref_frames[key], our_frames[key]
        for k in (set(rf) & set(of)) - TRANSPORT_KEYS:
            if rf[k] != of[k]:
                mismatches.append((key, k, rf[k], of[k]))
        if abs(int(rf["ST"]) - int(of["ST"])) > 3:
            mismatches.append((key, "ST", rf["ST"], of["ST"]))
    assert not mismatches, f"{len(mismatches)} mismatches: " \
                           f"{mismatches[:10]}"


def test_device_path_fixes_agree(ref_result, ours_device):
    """Fix trajectory through the fused device loop vs the reference:
    same epoch join as the host-path test, same bounds."""
    session = ours_device
    scn = _scenario()
    truth = scn.rec_ecef
    ref_fixes = np.array(ref_result["fixes"], dtype=np.float64)
    our_fixes = np.array([[p[0], p[1], p[2], p[3]]
                          for p in session.evaluator.positions],
                         dtype=np.float64)
    assert len(our_fixes) >= 100
    our_err = np.linalg.norm(our_fixes[:, 1:4] - truth, axis=1)
    ref_err = np.linalg.norm(ref_fixes[:, 1:4] - truth, axis=1)
    assert np.mean(our_err) < np.mean(ref_err) + 1.0
    ref_by_t = {round(t, 3): xyz for t, *xyz in ref_fixes}
    our_by_t = {round(t, 3): xyz for t, *xyz in our_fixes}
    common = sorted(set(ref_by_t) & set(our_by_t))
    assert len(common) >= 0.85 * len(ref_by_t), (
        f"only {len(common)} common epochs of {len(ref_by_t)}")
    d = np.array([np.linalg.norm(np.subtract(ref_by_t[t], our_by_t[t]))
                  for t in common])
    assert np.median(d) < 1.0, f"median separation {np.median(d):.2f} m"


# ---- N_CYC=16 axis (threshold note below): the reference's 16 ms fix-epoch mode ---------------

CFG16 = ReceiverConfig(n_cyc=16)


@pytest.fixture(scope="module")
def ref_result16():
    """The reference at N_CYC=16 (its documented fast-machine mode,
    gpsglob.py:122-124) on the SAME capture bytes — ref_driver patches
    gpsglob before the star-imports copy the globals."""
    return reference_result("diff_refresult16_v1.pkl", _capture_path,
                            "--n-cyc", "16")


@pytest.fixture(scope="module")
def ours16():
    from gps_sdr.runtime.session import Session

    path = _capture_path()
    session = Session(CFG16, record_epochs_to="memory")
    session.run_source(replay_blocks(path, CFG16))
    return session


def test_ncyc16_subframes_identical(ref_result16, ours16):
    """16 ms epoch mode: decoded subframe dicts must still match the
    reference field-for-field."""
    ref_frames = {}
    for sf in ref_result16["frames"]:
        ref_frames[(sf["SAT"], sf["ID"], sf["tow"])] = sf
    our_frames = {}
    for rec in ours16.records:
        for sf in rec[1]:
            if "ID" in sf:
                our_frames[(sf["SAT"], sf["ID"], sf["tow"])] = sf
    common = set(ref_frames) & set(our_frames)
    assert len(ref_frames) >= 25
    assert len(common) >= 0.9 * len(ref_frames), (
        f"only {len(common)}/{len(ref_frames)}; ours={len(our_frames)}")
    mismatches = []
    for key in sorted(common):
        rf, of = ref_frames[key], our_frames[key]
        for k in (set(rf) & set(of)) - TRANSPORT_KEYS:
            if rf[k] != of[k]:
                mismatches.append((key, k, rf[k], of[k]))
        if abs(int(rf["ST"]) - int(of["ST"])) > 3:
            mismatches.append((key, "ST", rf["ST"], of["ST"]))
    assert not mismatches, f"{mismatches[:10]}"


def test_ncyc16_fixes_agree(ref_result16, ours16):
    """16 ms epoch fixes join on the (16 ms-granular) timestamps.

    At N_CYC=16 each fix uses half the code-phase averaging, so the
    capture-inherent per-epoch scatter is ~10 m for BOTH pipelines
    (measured: ref 10.4 m / ours 9.7 m mean error) and sub-sample
    implementation differences (interpolation, slope engagement)
    decorrelate the per-epoch noise more than in the 32 ms mode.  The
    right differential claims are: no accuracy regression, a
    mean-position gap far under the scatter, and per-epoch separation
    a small fraction of the per-epoch error (measured: 0.45 m gap,
    median separation 2.3 m ~= 22% of the 10 m scatter)."""
    scn = _scenario()
    truth = scn.rec_ecef
    ref_fixes = np.array(ref_result16["fixes"], dtype=np.float64)
    our_fixes = np.array([[p[0], p[1], p[2], p[3]]
                          for p in ours16.evaluator.positions],
                         dtype=np.float64)
    assert len(ref_fixes) >= 200 and len(our_fixes) >= 200
    ref_err = np.linalg.norm(ref_fixes[:, 1:4] - truth, axis=1)
    our_err = np.linalg.norm(our_fixes[:, 1:4] - truth, axis=1)
    assert np.mean(our_err) < np.mean(ref_err) + 1.0
    assert np.linalg.norm(np.mean(ref_fixes[:, 1:4], axis=0)
                          - np.mean(our_fixes[:, 1:4], axis=0)) < 1.5
    ref_by_t = {round(t, 3): xyz for t, *xyz in ref_fixes}
    our_by_t = {round(t, 3): xyz for t, *xyz in our_fixes}
    common = sorted(set(ref_by_t) & set(our_by_t))
    assert len(common) >= 0.8 * len(ref_by_t), (
        f"{len(common)} of {len(ref_by_t)} common")
    d = np.array([np.linalg.norm(np.subtract(ref_by_t[t], our_by_t[t]))
                  for t in common])
    assert np.median(d) < 0.4 * np.mean(ref_err), (
        f"median separation {np.median(d):.2f} m vs scatter "
        f"{np.mean(ref_err):.2f} m")


# ---- N_CYC=8 axis: the third documented reference epoch mode
# (gpsglob.py:122-124, "N_CYC = 8 | 16 | 32").  8 ms epochs quarter the
# per-fix code-phase averaging, so the per-epoch scatter is the largest
# of the three modes and the differential claims follow the 16 ms
# pattern: no accuracy regression, mean-position gap far below the
# scatter, per-epoch separation a small fraction of the per-epoch error.

CFG8 = ReceiverConfig(n_cyc=8)


@pytest.fixture(scope="module")
def ref_result8():
    """The reference at N_CYC=8 on the SAME capture bytes (ref_driver
    patches gpsglob before the star-imports copy the globals)."""
    return reference_result("diff_refresult8_v1.pkl", _capture_path,
                            "--n-cyc", "8")


@pytest.fixture(scope="module")
def ours8():
    from gps_sdr.runtime.session import Session

    path = _capture_path()
    session = Session(CFG8, record_epochs_to="memory")
    session.run_source(replay_blocks(path, CFG8))
    return session


def test_ncyc8_subframes_identical(ref_result8, ours8):
    """8 ms epoch mode: decoded subframe dicts must still match the
    reference field-for-field."""
    ref_frames = {}
    for sf in ref_result8["frames"]:
        ref_frames[(sf["SAT"], sf["ID"], sf["tow"])] = sf
    our_frames = {}
    for rec in ours8.records:
        for sf in rec[1]:
            if "ID" in sf:
                our_frames[(sf["SAT"], sf["ID"], sf["tow"])] = sf
    common = set(ref_frames) & set(our_frames)
    # 8 sats x 3 subframes in the 48 s capture: the reference decodes
    # 24 at this epoch mode (measured)
    assert len(ref_frames) >= 20
    assert len(common) >= 0.9 * len(ref_frames), (
        f"only {len(common)}/{len(ref_frames)}; ours={len(our_frames)}")
    mismatches = []
    for key in sorted(common):
        rf, of = ref_frames[key], our_frames[key]
        for k in (set(rf) & set(of)) - TRANSPORT_KEYS:
            if rf[k] != of[k]:
                mismatches.append((key, k, rf[k], of[k]))
        if abs(int(rf["ST"]) - int(of["ST"])) > 3:
            mismatches.append((key, "ST", rf["ST"], of["ST"]))
    assert not mismatches, f"{mismatches[:10]}"


def test_ncyc8_fixes_agree(ref_result8, ours8):
    """8 ms epoch fixes join on the (8 ms-granular) timestamps.

    At N_CYC=8 each fix averages a QUARTER of the 32-mode's code
    phases, so the reference's per-epoch scatter doubles again
    (measured 19.9 m vs 10.4 m at 16 / 9.5 m at 32 — the expected
    sqrt(4)).  This repo does NOT degrade the same way (measured
    9.3 m): its sigma/slope segments anchor to the absolute 1 s
    stream grid (models/pseudorange.py _sigma_and_slope) rather than
    shrinking with the epoch length, so its LSF weights stay
    calibrated.  Per-epoch noise between the pipelines is therefore
    nearly decorrelated and the honest differential claims are
    scatter-relative: no accuracy regression, a mean-position gap
    well under the reference's scatter (measured 0.23x), and a
    median per-epoch separation below it (measured 0.79x)."""
    scn = _scenario()
    truth = scn.rec_ecef
    ref_fixes = np.array(ref_result8["fixes"], dtype=np.float64)
    our_fixes = np.array([[p[0], p[1], p[2], p[3]]
                          for p in ours8.evaluator.positions],
                         dtype=np.float64)
    assert len(ref_fixes) >= 300 and len(our_fixes) >= 300
    ref_err = np.linalg.norm(ref_fixes[:, 1:4] - truth, axis=1)
    our_err = np.linalg.norm(our_fixes[:, 1:4] - truth, axis=1)
    scatter = np.mean(ref_err)
    assert np.mean(our_err) < scatter + 1.5
    assert np.linalg.norm(np.mean(ref_fixes[:, 1:4], axis=0)
                          - np.mean(our_fixes[:, 1:4], axis=0)) \
        < 0.35 * scatter
    ref_by_t = {round(t, 3): xyz for t, *xyz in ref_fixes}
    our_by_t = {round(t, 3): xyz for t, *xyz in our_fixes}
    common = sorted(set(ref_by_t) & set(our_by_t))
    assert len(common) >= 0.8 * len(ref_by_t), (
        f"{len(common)} of {len(ref_by_t)} common")
    d = np.array([np.linalg.norm(np.subtract(ref_by_t[t], our_by_t[t]))
                  for t in common])
    assert np.median(d) < scatter, (
        f"median separation {np.median(d):.2f} m vs scatter "
        f"{scatter:.2f} m")
