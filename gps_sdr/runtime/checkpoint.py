"""Mid-run receiver checkpoint / resume.

The reference has NO mid-run DSP-state checkpointing (SURVEY.md section
5: its only resume mechanisms are the 2 h ephemeris JSON cache, the
receiver-output pickle replay, and the START_STREAM file offset) — a
restarted reference receiver re-acquires from cold and waits ~30 s per
satellite for fresh ephemerides.  Here the whole tracking state is an
explicit pytree, so checkpointing is one packed f32 download
(ops/tracking.py pack_states — the transfer boundary carries f32
only; complex splits into re/im, long counters into hi/lo planes) plus
a pickle of the small host-side objects:

  device  ChannelState           (PLL/NCO, code phase, decode carries,
                                  quality rings — everything the scan
                                  threads between chunks)
  host    SlotTable, NavDecoders, ReceiverStatus, corr_quality
  host    Evaluator              (pseudorange engines, ephemerides,
                                  time references, positions, stats)

`save_session` / `load_session` round-trip a whole Session: a resumed
receiver continues mid-stream with locked channels, bit framing, and
pseudorange time references intact (tests/test_checkpoint.py pins
epoch-for-epoch equality against an uninterrupted run).
"""

from __future__ import annotations

import pickle

import numpy as np

# v2 (round 5): Evaluator stores all_pos as _pos_buf/_pos_n and
# sat_results as a TupleLog; PseudorangeEngine stores cp_hist as
# hist_snos/hist_cps — v1 pickles would load but crash on first use,
# so the version gate must reject them
FORMAT_VERSION = 2


def _receiver_payload(rec) -> dict:
    from gps_sdr.ops.tracking import pack_states

    return {
        "states_f32": {k: np.asarray(v)
                       for k, v in pack_states(rec.states).items()},
        "slot_prn": list(rec.slots.slot_prn),
        "decoders": rec.decoders,
        "status": rec.status,
        "corr_quality": dict(rec.corr_quality),
        "sweep_all": rec.sweep_all,
    }


def _restore_receiver(rec, p: dict) -> None:
    import jax.numpy as jnp

    from gps_sdr.ops.tracking import to_f32_pairs, unpack_states

    rec.states = unpack_states(
        {k: jnp.asarray(v) for k, v in p["states_f32"].items()})
    rec.slots.slot_prn = list(p["slot_prn"])
    rec.decoders = p["decoders"]
    rec.status = p["status"]
    rec.corr_quality = p["corr_quality"]
    rec.sweep_all = p["sweep_all"]
    # Slot code tables are pure functions of slot_prn — rebuild from the
    # per-PRN tables instead of persisting ~max_sat*2048 complex values.
    rec._codes[:] = 0
    rec._ffts[:] = 0
    for slot, prn in enumerate(rec.slots.slot_prn):
        if prn:
            rec._codes[slot] = rec._codes_tab[prn]
            rec._ffts[slot] = rec._ffts_tab[prn]
    rec._codes_dev = jnp.asarray(rec._codes)
    rec._ffts_dev = jnp.asarray(to_f32_pairs(rec._ffts))


def save_session(session, path: str) -> None:
    """Checkpoint a Session (receiver device+host state and evaluator)
    to `path` (a single pickle file; numpy arrays inline)."""
    payload = {
        "version": FORMAT_VERSION,
        "cfg": session.receiver.cfg,
        **_receiver_payload(session.receiver),
        "evaluator": session.evaluator,
        "summaries": list(session.summaries),
    }
    with open(path, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)


def save_server(server, evaluators: list, path: str) -> None:
    """Checkpoint a StreamServer (all streams' receivers) plus the
    caller's per-stream evaluators — the serving-path analogue of
    save_session (one file; numpy arrays inline)."""
    payload = {
        "version": FORMAT_VERSION,
        "cfg": server.cfg,
        "receivers": [_receiver_payload(r) for r in server.receivers],
        "evaluators": list(evaluators),
    }
    with open(path, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)


def load_server(path: str, mesh=None):
    """Rebuild (StreamServer, evaluators) from a save_server checkpoint;
    every stream resumes exactly where it left off (the stacked device
    state is re-uploaded on the next run)."""
    from gps_sdr.runtime.serving import StreamServer

    with open(path, "rb") as f:
        p = pickle.load(f)
    if p["version"] != FORMAT_VERSION:
        raise ValueError(f"unknown checkpoint version {p['version']}")
    server = StreamServer(p["cfg"], len(p["receivers"]), mesh=mesh)
    for rec, rp in zip(server.receivers, p["receivers"]):
        _restore_receiver(rec, rp)
    return server, p["evaluators"]


def load_session(path: str, reporter=None):
    """Rebuild a Session from a checkpoint; tracking resumes exactly
    where `save_session` left off."""
    from gps_sdr.runtime.session import Session

    with open(path, "rb") as f:
        p = pickle.load(f)
    if p["version"] != FORMAT_VERSION:
        raise ValueError(f"unknown checkpoint version {p['version']}")

    session = Session(p["cfg"], reporter=reporter)
    _restore_receiver(session.receiver, p)
    session.evaluator = p["evaluator"]
    session.summaries = list(p["summaries"])
    return session
