"""Lazy gate for the native host evaluator core (_evalcore bindings).

`native_evalcore()` returns the binding module, or False when the
shared library is unavailable or GSDR_EVALCORE=0 (the equivalence-test
switch, mirroring GSDR_NAVSCAN).  Callers keep their numpy paths as
the semantic source of truth and consult this gate per call — cheap
(module-global memo) and late enough that tests can flip the env var
between calls."""

from __future__ import annotations

import os

_core = None


def load_native_lib(lib_path: str, build_env_var: str):
    """Load a prebuilt csrc shared library via ctypes.

    Never compiles by default — an import-time `make` could stall the
    first call for minutes on the 1-core host and hides a broken
    toolchain; set `build_env_var`=1 to opt in to building.  Raises
    ImportError with the build hint otherwise.  Shared by the
    _evalcore and models/_navscan bindings."""
    import ctypes

    try:
        return ctypes.CDLL(lib_path)
    except OSError as e:
        first_err = e
    if os.environ.get(build_env_var, "0") == "1":
        import subprocess
        csrc = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "..", "csrc")
        try:
            subprocess.run(["make", "-C", csrc], check=True,
                           capture_output=True, timeout=120)
            return ctypes.CDLL(lib_path)
        except Exception as e:
            first_err = e
    raise ImportError(
        f"native library unavailable ({first_err}); "
        f"run `make -C csrc` (or set {build_env_var}=1)")


def native_evalcore():
    """The _evalcore binding module, or False."""
    global _core
    if os.environ.get("GSDR_EVALCORE", "1") == "0":
        return False
    if _core is None:
        try:
            from gps_sdr import _evalcore
            _core = _evalcore
        except ImportError as e:
            import warnings
            warnings.warn(f"native evalcore unavailable, using the "
                          f"numpy host path ({e})", RuntimeWarning,
                          stacklevel=2)
            _core = False
    return _core
