"""StreamServer: S receivers served from one device program must equal
independent single-receiver runs (tracking epochs, code phases, frames),
including cold-start acquisition and the pipelined compact download."""

import numpy as np

from gps_sdr.config import ReceiverConfig
from gps_sdr.models.scenario import make_scenario
from gps_sdr.models.scenario_jax import DeviceScenarioSynth
from gps_sdr.runtime.receiver import Receiver
from gps_sdr.runtime.serving import StreamServer

CFG = ReceiverConfig()
SEC = 8


def _epochs_equal(a, b):
    assert a.skipped_samples == b.skipped_samples
    assert sorted(a.code_phases) == sorted(b.code_phases)
    for prn in a.code_phases:
        np.testing.assert_allclose(
            np.asarray([c for _, c in a.code_phases[prn]]),
            np.asarray([c for _, c in b.code_phases[prn]]), atol=1e-5)
    assert len(a.frames) == len(b.frames)
    for fa, fb in zip(a.frames, b.frames):
        assert fa.get("SAT") == fb.get("SAT")
        assert fa.get("tow") == fb.get("tow")


def test_stream_server_matches_single_receiver():
    scn = make_scenario(CFG, n_sats=4, duration_sec=SEC + 6.0, seed=5)
    dev = DeviceScenarioSynth(scn, noise_std=0.4)
    t = CFG.no_sec
    n_chunks = int(round(SEC / (t * CFG.block_sec)))

    ref = Receiver(CFG)
    ref_epochs = list(ref.run_device(dev.chunk_planar, n_chunks))

    srv = StreamServer(CFG, 2)
    got = {0: [], 1: []}
    for s, epoch in srv.run(dev.chunk_planar, n_chunks):
        got[s].append(epoch)

    assert len(got[0]) == len(got[1]) == len(ref_epochs) > 0
    for s in (0, 1):
        for ea, eb in zip(got[s], ref_epochs):
            _epochs_equal(ea, eb)
    # both streams acquired the scenario's satellites
    for rec in srv.receivers:
        assert len(rec.slots.active) >= 3


def test_stream_server_sharded_matches_unsharded():
    """Stream axis sharded over a 4-device mesh == single-device run.

    Streams share no state, so the mesh layout must be a pure
    performance choice (parallel/mesh.py make_stream_mesh)."""
    from gps_sdr.parallel.mesh import make_stream_mesh

    scn = make_scenario(CFG, n_sats=4, duration_sec=SEC + 6.0, seed=7)
    dev = DeviceScenarioSynth(scn, noise_std=0.4)
    t = CFG.no_sec
    n_chunks = int(round(SEC / (t * CFG.block_sec)))

    plain = StreamServer(CFG, 4)
    got_p = {s: [] for s in range(4)}
    for s, epoch in plain.run(dev.chunk_planar, n_chunks):
        got_p[s].append(epoch)

    srv = StreamServer(CFG, 4, mesh=make_stream_mesh(4))
    got_m = {s: [] for s in range(4)}
    for s, epoch in srv.run(dev.chunk_planar, n_chunks):
        got_m[s].append(epoch)

    for s in range(4):
        assert len(got_m[s]) == len(got_p[s]) > 0
        for ea, eb in zip(got_m[s], got_p[s]):
            _epochs_equal(ea, eb)


def test_stream_server_window_epochs_match_per_chunk():
    """epoch_per_window serving == merge_epochs over the per-chunk
    serving stream (the bench serving headline path runs on this exact
    branch: per-stream outs concat + one consume per window)."""
    from gps_sdr.runtime.evaluator import merge_epochs

    sec = 16        # long enough that actual subframes decode
    scn = make_scenario(CFG, n_sats=4, duration_sec=sec + 6.0, seed=5)
    dev = DeviceScenarioSynth(scn, noise_std=0.4)
    t = CFG.no_sec
    n_chunks = int(round(sec / (t * CFG.block_sec)))
    w = 4

    cfg_pc = CFG.replace(chunks_per_download=w, defer_subframe_poll=True)
    pc = StreamServer(cfg_pc, 2)
    got_pc = {0: [], 1: []}
    for s, epoch in pc.run(dev.chunk_planar, n_chunks):
        got_pc[s].append(epoch)

    cfg_w = CFG.replace(chunks_per_download=w, epoch_per_window=True)
    sw = StreamServer(cfg_w, 2)
    got_w = {0: [], 1: []}
    for s, epoch in sw.run(dev.chunk_planar, n_chunks):
        got_w[s].append(epoch)

    for s in (0, 1):
        merged = [merge_epochs(got_pc[s][i:i + w])
                  for i in range(0, len(got_pc[s]), w)]
        assert len(got_w[s]) == len(merged) > 0
        for ea, eb in zip(got_w[s], merged):
            assert sorted(ea.code_phases.items()) == \
                sorted(eb.code_phases.items())
            # subframe-carrying frames identical; report frames come
            # from the window's last chunk only
            ka = sorted(str(sorted(f.items()))
                        for f in ea.frames if "ID" in f)
            kb = sorted(str(sorted(f.items()))
                        for f in eb.frames if "ID" in f)
            assert ka == kb
    assert any("ID" in f for eps in got_w.values()
               for e in eps for f in e.frames)


def test_process_many_matches_per_stream():
    """Cross-stream batched evaluation (evaluator.process_many) must be
    row-for-row identical to per-stream Evaluator.process — same
    positions, stats, sat_results — because ecef_coord is elementwise
    and stacking streams only grows the batch."""
    from gps_sdr.models.scenario import make_scenario as mk
    from gps_sdr.runtime.evaluator import Evaluator, process_many
    from gps_sdr.runtime.receiver import Receiver

    sec = 20.0
    scn = mk(CFG, n_sats=6, duration_sec=sec + 12.0, seed=4)
    dev = DeviceScenarioSynth(scn, noise_std=0.5)
    t = CFG.no_sec
    n_chunks = int(round(sec / (t * CFG.block_sec)))
    ephs = {s.prn: {"SAT": s.prn, **s.eph} for s in scn.sats}

    rec = Receiver(CFG)
    epochs = list(rec.run_device(dev.chunk_planar, n_chunks))
    assert len(epochs) >= 3

    # 3 "streams" with identical inputs: per-stream sequential vs
    # batched must agree element-for-element
    seq = [Evaluator(CFG, preloaded_ephem=dict(ephs)) for _ in range(3)]
    bat = [Evaluator(CFG, preloaded_ephem=dict(ephs)) for _ in range(3)]
    for e in epochs:
        for ev in seq:
            ev.process(e)
        process_many([(ev, e) for ev in bat])

    assert len(seq[0].positions) > 0
    for a, b in zip(seq, bat):
        assert a.positions == b.positions
        assert a.sat_results == b.sat_results
        assert a.fix_failures == b.fix_failures
        assert len(a.velocities) == len(b.velocities)


def test_process_many_heterogeneous_streams():
    """Cross-stream stacked GN (evaluator._solve_fixes_many) with
    streams of DIFFERENT satellite counts: the smaller stream's epochs
    pad to the global count with 1e7-sigma duplicate columns (weight
    ~1e-14 of a real row), so batched positions must match per-stream
    evaluation to far below the fix noise floor."""
    from gps_sdr.models.scenario import make_scenario as mk
    from gps_sdr.runtime.evaluator import Evaluator, process_many
    from gps_sdr.runtime.receiver import Receiver

    sec = 20.0
    t = CFG.no_sec
    n_chunks = int(round(sec / (t * CFG.block_sec)))
    streams = []
    for n_sats, seed in ((6, 4), (5, 11)):
        scn = mk(CFG, n_sats=n_sats, duration_sec=sec + 12.0, seed=seed)
        dev = DeviceScenarioSynth(scn, noise_std=0.5)
        ephs = {s.prn: {"SAT": s.prn, **s.eph} for s in scn.sats}
        rec = Receiver(CFG)
        epochs = list(rec.run_device(dev.chunk_planar, n_chunks))
        assert len(epochs) >= 3
        streams.append((ephs, epochs))

    seq = [Evaluator(CFG, preloaded_ephem=dict(e)) for e, _ in streams]
    bat = [Evaluator(CFG, preloaded_ephem=dict(e)) for e, _ in streams]
    for i in range(min(len(eps) for _, eps in streams)):
        for ev, (_, eps) in zip(seq, streams):
            ev.process(eps[i])
        process_many([(ev, eps[i])
                      for ev, (_, eps) in zip(bat, streams)])

    for a, b in zip(seq, bat):
        assert len(a.positions) == len(b.positions) > 0
        assert a.fix_failures == b.fix_failures
        pa, pb = np.asarray(a.positions), np.asarray(b.positions)
        np.testing.assert_allclose(pa[:, 1:], pb[:, 1:], atol=1e-4)
        np.testing.assert_allclose(pa[:, 0], pb[:, 0], atol=1e-9)


def test_fused_window_dispatch_identical():
    """fused_window_dispatch=True (one track+pack program per download
    window, ops/tracking.py track_streams_window) must yield the
    identical epoch stream as the per-chunk dispatch loop — it is a
    pure dispatch-batching change."""
    scn = make_scenario(CFG, n_sats=4, duration_sec=SEC + 6.0, seed=5)
    dev = DeviceScenarioSynth(scn, noise_std=0.4)
    t = CFG.no_sec
    n_chunks = int(round(SEC / (t * CFG.block_sec)))
    got = {}
    for fused in (False, True):
        cfg = CFG.replace(chunks_per_download=2,
                          download_windows_in_flight=2,
                          fused_window_dispatch=fused)
        srv = StreamServer(cfg, 2)
        eps = {0: [], 1: []}
        for s, epoch in srv.run(dev.chunk_planar, n_chunks):
            eps[s].append(epoch)
        got[fused] = eps
    for s in (0, 1):
        assert len(got[True][s]) == len(got[False][s]) > 0
        for ea, eb in zip(got[True][s], got[False][s]):
            _epochs_equal(ea, eb)


def test_fused_window_independent_providers_identical():
    """Independent front ends (one provider per stream): the fused
    window dispatch stacks S windows ([w, S, t, *iq]) and must yield
    exactly what the per-chunk loop yields for each stream."""
    t = CFG.no_sec
    n_chunks = int(round(SEC / (t * CFG.block_sec)))
    devs = [DeviceScenarioSynth(
        make_scenario(CFG, n_sats=4, duration_sec=SEC + 6.0, seed=sd),
        noise_std=0.4) for sd in (5, 11)]
    got = {}
    for fused in (False, True):
        cfg = CFG.replace(chunks_per_download=2,
                          download_windows_in_flight=2,
                          fused_window_dispatch=fused)
        srv = StreamServer(cfg, 2)
        eps = {0: [], 1: []}
        for s, epoch in srv.run([d.chunk_planar for d in devs],
                                n_chunks):
            eps[s].append(epoch)
        got[fused] = eps
    # the two streams see different skies - must differ from each other
    assert not all(
        sorted(a.code_phases) == sorted(b.code_phases)
        for a, b in zip(got[True][0], got[True][1]))
    for s in (0, 1):
        assert len(got[True][s]) == len(got[False][s]) > 0
        for ea, eb in zip(got[True][s], got[False][s]):
            _epochs_equal(ea, eb)


def test_shared_cold_start_sweeps_once(monkeypatch):
    """Shared-capture replicas see identical blocks, so the serving
    cold start must run the device acquisition grid ONCE and replicate
    the result — not one full sweep per stream (the equality-vs-single-
    receiver test above pins that the replicated result is identical)."""
    from gps_sdr.runtime import receiver as receiver_mod

    scn = make_scenario(CFG, n_sats=4, duration_sec=SEC + 6.0, seed=5)
    dev = DeviceScenarioSynth(scn, noise_std=0.4)
    t = CFG.no_sec
    n_chunks = int(round(SEC / (t * CFG.block_sec)))

    calls = {"n": 0}
    real = receiver_mod.acquire_all

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(receiver_mod, "acquire_all", counting)
    srv = StreamServer(CFG, 4)
    n_ep = sum(1 for _ in srv.run(dev.chunk_planar, n_chunks))
    assert n_ep == 4 * n_chunks
    assert calls["n"] == 1, f"expected 1 shared sweep, got {calls['n']}"
    for rec in srv.receivers:
        assert len(rec.slots.active) >= 3
