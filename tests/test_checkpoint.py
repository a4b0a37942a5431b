"""Mid-run checkpoint/resume (runtime/checkpoint.py).

A resumed session must continue EXACTLY where the saved one left off:
same tracking state (pack_states round trip is exact), same epochs,
same decoded frames.  The reference has no equivalent — a restart
re-acquires cold and re-collects ephemerides (SURVEY.md section 5)."""

import itertools

import numpy as np
import jax.numpy as jnp

from gps_sdr.config import ReceiverConfig
from gps_sdr.models.simulator import SatSignal, random_bits, synth_stream
from gps_sdr.ops.tracking import (init_channel_states, pack_states,
                                  reset_channel, unpack_states)
from gps_sdr.runtime.checkpoint import load_session, save_session
from gps_sdr.runtime.session import Session
from tests.conftest import cached_synth

CFG = ReceiverConfig(max_sat=2)
SATS = [
    SatSignal(prn=5, doppler=1234.0, code_delay=300.25,
              nav_bits=random_bits(128, seed=5)),
    SatSignal(prn=21, doppler=-3100.0, code_delay=777.0,
              nav_bits=random_bits(128, seed=21)),
]


def _stream():
    return cached_synth(
        "batched_track_v1",
        lambda: synth_stream(CFG, SATS, 96, noise_std=0.4, seed=11))


def test_pack_states_roundtrip_exact():
    st = init_channel_states(CFG, 2)
    st = reset_channel(st, 0, 5, 1234.0, 300, CFG)
    st = reset_channel(st, 1, 21, -3100.0, 777, CFG)
    # exercise the hi/lo counter split beyond f32's 2^24 exact range
    st = st._replace(
        ms_time=jnp.asarray([40_000_000, 17_000_001], jnp.int32),
        prev_stream=jnp.asarray([20_000_000, 3], jnp.int32),
        carry_sum=jnp.asarray([1.5 - 2.25j, -0.125 + 7j], jnp.complex64))
    back = unpack_states({k: jnp.asarray(np.asarray(v))
                          for k, v in pack_states(st).items()})
    for name in st._fields:
        np.testing.assert_array_equal(np.asarray(getattr(st, name)),
                                      np.asarray(getattr(back, name)),
                                      err_msg=name)
        assert getattr(back, name).dtype == getattr(st, name).dtype, name


def _epoch_key(e):
    return (e.skipped_samples,
            sorted((sat, tuple(map(tuple, lst)))
                   for sat, lst in e.code_phases.items()),
            [sorted(sf.items()) for sf in e.frames])


def test_resume_continues_identically(tmp_path):
    blocks = _stream()
    path = str(tmp_path / "ckpt.pkl")

    # uninterrupted reference run
    ref_session = Session(CFG)
    ref_epochs = list(ref_session.receiver.run(iter(blocks)))
    for e in ref_epochs:
        ref_session._consume(e)

    # interrupted run: first chunk(s), checkpoint, resume, rest.
    # the cold-start sweep consumes block 0, so feed blocks one by one
    # and split after the first epoch is out.
    s1 = Session(CFG)
    it = iter(blocks)
    gen = s1.receiver.run(it)
    got_epochs = [next(gen)]
    s1._consume(got_epochs[0])
    gen.close()
    consumed = s1.receiver.status.stream_no      # blocks eaten so far
    save_session(s1, path)

    s2 = load_session(path)
    for e in s2.receiver.run(iter(blocks[consumed:])):
        s2._consume(e)
        got_epochs.append(e)

    assert len(got_epochs) == len(ref_epochs)
    for a, b in zip(ref_epochs, got_epochs):
        assert _epoch_key(a) == _epoch_key(b)
    # evaluator state carried across: same running results
    assert (s2.evaluator.sat_results == ref_session.evaluator.sat_results)
    assert s2.evaluator.positions == ref_session.evaluator.positions


def test_cli_save_and_resume(tmp_path):
    """CLI surface: replay --save-state, then --resume-state with
    --start-stream continuing the same capture."""
    import subprocess
    import sys

    from gps_sdr.runtime.sources import pack_iq

    cfg = ReceiverConfig()
    sat = SatSignal(prn=9, doppler=1500.0, code_delay=100.0,
                    nav_bits=random_bits(64, seed=1))
    blocks = 0.25 * cached_synth(
        "recovery_skip_v1", lambda: synth_stream(
            cfg, [sat], n_blocks=3 * cfg.no_sec + 1, noise_std=0.4))
    cap = tmp_path / "cap.bin"
    with open(cap, "wb") as f:
        for b in blocks:
            pack_iq(b).tofile(f)

    def run(args):
        return subprocess.run(
            [sys.executable, "-m", "gps_sdr", *args],
            capture_output=True, text=True, timeout=300,
            env={"PATH": "/usr/bin:/bin", "HOME": "/root",
                 "JAX_PLATFORMS": "cpu", "PYTHONPATH": "."},
            cwd="/root/repo")

    ck = str(tmp_path / "state.pkl")
    r1 = run(["replay", str(cap), "--max-sat", "2", "--ui", "none",
              "--max-sec", "2.0", "--save-state", ck])
    assert r1.returncode == 0, r1.stdout + r1.stderr
    assert "checkpoint saved" in r1.stdout

    # resume: skip what the first run consumed (2 s + the sweep block)
    skip = int(2.0 / cfg.block_sec) + 1
    r2 = run(["replay", str(cap), "--max-sat", "2", "--ui", "headless",
              "--start-stream", str(skip), "--resume-state", ck])
    assert r2.returncode == 0, r2.stdout + r2.stderr
    # the resumed run keeps tracking PRN 9 without a new cold sweep
    assert "09" in r2.stdout


def test_resume_with_full_feature_state(tmp_path):
    """Checkpoint/resume with every stateful feature on — Hatch filter
    states, Kalman track filter, iono coefficients, velocity series,
    clock-rate estimate — must continue epoch-for-epoch identically
    (the filter state lives in the pickled evaluator; a reset would
    show as a jump in the filtered track)."""
    import numpy as np

    from gps_sdr.runtime.sources import replay_blocks
    from tests.test_atmos_closed_loop import CFG as ACFG
    from tests.test_atmos_closed_loop import _capture_path

    cfg = ACFG.replace(carrier_smoothing=32, track_filter_q=1.0,
                       solve_clock_rate=True)
    path = _capture_path()
    ckpt = str(tmp_path / "full.pkl")

    ref = Session(cfg)
    ref.run_source(replay_blocks(path, cfg))

    # interrupted at ~2/3 through (fixes and filter already running)
    s1 = Session(cfg)
    n_blocks = 0
    gen = s1.receiver.run(replay_blocks(path, cfg))
    for e in gen:
        s1._consume(e)
        n_blocks = s1.receiver.status.stream_no
        if n_blocks >= 26 * cfg.no_sec:
            break
    gen.close()
    save_session(s1, ckpt)

    s2 = load_session(ckpt)
    for e in s2.receiver.run(replay_blocks(path, cfg,
                                           start_stream=n_blocks)):
        s2._consume(e)

    assert len(s2.evaluator.positions) == len(ref.evaluator.positions)
    assert np.allclose(s2.evaluator.positions, ref.evaluator.positions)
    assert len(s2.evaluator.filtered) == len(ref.evaluator.filtered)
    assert np.allclose(s2.evaluator.filtered, ref.evaluator.filtered)
    assert np.allclose(s2.evaluator.velocities,
                       ref.evaluator.velocities)
    assert s2.evaluator.iono_params == ref.evaluator.iono_params
    assert np.isclose(s2.evaluator.clock_rate_est,
                      ref.evaluator.clock_rate_est)


def test_device_path_resume_continues_fixes(tmp_path):
    """Checkpoint/resume through run_device: the resumed receiver must
    keep producing fixes.  Regression: run_device reset stream_no to
    the chunk index, so a resumed receiver's stream numbers jumped
    backward and the pseudorange engines silently discarded every
    later code phase (found by the 2 h soak: exactly half the fixes)."""
    import numpy as np

    from gps_sdr.models.scenario import make_scenario
    from gps_sdr.models.scenario_jax import DeviceScenarioSynth
    from gps_sdr.runtime.session import Session

    cfg = ReceiverConfig(download_windows_in_flight=2,
                         chunks_per_download=4,
                         defer_subframe_poll=True, epoch_per_window=True)
    sig = 56.0
    n_chunks = int(round(sig / (cfg.no_sec * cfg.block_sec)))
    scn = make_scenario(cfg, n_sats=6, duration_sec=sig + 12.0, seed=4)
    dev = DeviceScenarioSynth(scn, noise_std=0.5)

    def provider(off):
        t = cfg.no_sec
        return lambda first, n: dev.chunk_planar(off * t + first, n)

    half = n_chunks // 2
    path = str(tmp_path / "dev_ckpt.pkl")
    s1 = Session(cfg)
    # preloaded ephemerides: fixes need only a decoded time reference
    # (~13 s), so both halves of the short capture produce them
    s1.evaluator.preloaded_ephem.update(
        {s.prn: {"SAT": s.prn, **s.eph} for s in scn.sats})
    s1.run_device_source(provider(0), half)
    n_half = len(s1.evaluator.positions)
    assert n_half > 0, "no fixes before the checkpoint"
    save_session(s1, path)

    s2 = load_session(path)
    s2.run_device_source(provider(half), n_chunks - half)
    pos = np.array(s2.evaluator.positions)
    assert len(pos) > 1.5 * n_half, (
        f"resumed half added too few fixes: {n_half} -> {len(pos)}")
    t_rel = pos[:, 0] - pos[0, 0]
    late = int((t_rel > 0.6 * t_rel[-1]).sum())
    assert late > 0.2 * len(pos), "no fixes in the resumed segment"


def test_server_checkpoint_resume_matches_uninterrupted(tmp_path):
    """Serving-path checkpoint (save_server/load_server): a mid-run
    checkpoint + resume of a StreamServer must produce the same epochs
    per stream as an uninterrupted run on the same capture."""
    import jax

    from gps_sdr.ops.tracking import to_grouped_planar
    from gps_sdr.runtime.checkpoint import load_server, save_server
    from gps_sdr.runtime.serving import StreamServer

    blocks = np.stack(_stream())
    cfg = CFG.replace(chunks_per_download=2,
                      download_windows_in_flight=2,
                      defer_subframe_poll=True, epoch_per_window=True)
    t = cfg.no_sec
    n_chunks = blocks.shape[0] // t
    buf = jnp.asarray(to_grouped_planar(cfg, blocks[:n_chunks * t]))

    def provider(offset):
        def p(first, n):
            import jax.numpy as jnp2
            return jax.lax.dynamic_slice_in_dim(
                buf, offset * t + int(first), n)
        return p

    def collect(srv, prov, chunks):
        # flatten: the checkpoint shifts window boundaries, so epochs
        # REGROUP (epoch_per_window) — the invariant is the underlying
        # per-satellite series and frame stream, not the packing
        out = [{"coph": {}, "frames": []} for _ in range(2)]
        for s, epoch in srv.run(prov, chunks):
            for sat, lst in epoch.code_phases.items():
                out[s]["coph"].setdefault(sat, []).extend(
                    (int(n), float(c)) for n, c in lst)
            # nav-field frames only: AMP/CN0/CRM/FRQ are telemetry
            # sampled at the window's last block, which legitimately
            # moves when the checkpoint shifts window boundaries
            skip = {"AMP", "CN0", "CRM", "FRQ", "SWP", "EPH"}
            out[s]["frames"] += [tuple(sorted(
                (k, v) for k, v in sf.items()
                if k not in skip and isinstance(
                    v, (int, float, str, bool))))
                for sf in epoch.frames if "ID" in sf]
        return out

    ref = StreamServer(cfg, 2)
    ref_flat = collect(ref, provider(0), n_chunks)

    half = n_chunks // 2
    s1 = StreamServer(cfg, 2)
    got = collect(s1, provider(0), half)
    path = str(tmp_path / "srv.pkl")
    save_server(s1, ["ev0", "ev1"], path)
    s2, evs = load_server(path)
    assert evs == ["ev0", "ev1"]
    more = collect(s2, provider(half), n_chunks - half)
    for s in range(2):
        for sat, lst in more[s]["coph"].items():
            got[s]["coph"].setdefault(sat, []).extend(lst)
        got[s]["frames"] += more[s]["frames"]

    for s in range(2):
        assert set(got[s]["coph"]) == set(ref_flat[s]["coph"])
        for sat in ref_flat[s]["coph"]:
            assert got[s]["coph"][sat] == ref_flat[s]["coph"][sat], (
                f"stream {s} sat {sat} code-phase series mismatch")
        assert got[s]["frames"] == ref_flat[s]["frames"], (
            f"stream {s} frame stream mismatch")
