"""gps_sdr — a GPS L1 C/A software receiver on JAX/XLA.

A from-scratch JAX/XLA re-design of the capabilities of the
annappo/GPS-SDR-Receiver reference (a pure-Python multiprocessing
receiver): IQ ingest, batched FFT acquisition over the PRN x Doppler x
code-phase grid, scan-based per-channel DLL/PLL tracking, 50 bps nav
message decode (subframes -> ephemerides), pseudorange assembly and an
iterated weighted Gauss-Newton position fix.

Architecture (vs. reference layers, see SURVEY.md):
  L0 config            -> gps_sdr.config        (frozen dataclass)
  L1 sample source     -> gps_sdr.runtime.sources + csrc ingest
  L2 dispatcher        -> gps_sdr.runtime.receiver (host shell)
  L3 acquisition       -> gps_sdr.ops.acquisition  (batched jit)
  L4 channel tracking  -> gps_sdr.ops.tracking     (vmap+scan)
  L5 nav decode        -> gps_sdr.models.navmsg    (host bit ops)
  L6 orbit/ephemeris   -> gps_sdr.models.{ephemeris,orbits,pseudorange}
  L7 positioning       -> gps_sdr.ops.pvt
  L8 UI/export         -> gps_sdr.ui, gps_sdr.utils.io
  L9 launcher          -> gps_sdr.runtime.session
Multi-device scaling  -> gps_sdr.parallel (mesh, channel sharding,
                         overlap-save time sharding)
"""

__version__ = "0.1.0"

from gps_sdr.config import ReceiverConfig  # noqa: F401


def __getattr__(name):  # lazy: keep `import gps_sdr` JAX-free
    import importlib

    top = {
        "Session": ("gps_sdr.runtime.session", "Session"),
        "Receiver": ("gps_sdr.runtime.receiver", "Receiver"),
        "Evaluator": ("gps_sdr.runtime.evaluator", "Evaluator"),
        "EpochInput": ("gps_sdr.runtime.evaluator", "EpochInput"),
        "acquire": ("gps_sdr.ops.acquisition", "acquire"),
        "acquire_all": ("gps_sdr.ops.acquisition", "acquire_all"),
        "track_chunk": ("gps_sdr.ops.tracking", "track_chunk"),
        "track_chunk_batched": ("gps_sdr.ops.tracking",
                                "track_chunk_batched"),
        "track_streams": ("gps_sdr.ops.tracking", "track_streams"),
        "make_mesh": ("gps_sdr.parallel.mesh", "make_mesh"),
        "track_sharded": ("gps_sdr.parallel.tracking",
                          "track_sharded"),
        "acquire_sharded": ("gps_sdr.parallel.acquisition",
                            "acquire_sharded"),
    }
    if name in top:
        mod, attr = top[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'gps_sdr' has no attribute {name!r}")
