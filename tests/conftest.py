"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-chip hardware is not assumed; sharding tests use
--xla_force_host_platform_device_count (SURVEY.md section 4, multi-host
testing strategy).  JAX_PLATFORMS defaults to cpu here; tests marked
`gpu` (pyproject.toml) need a card and skip without one
(tests/test_gpu.py).
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# persistent compilation cache: JAX_COMPILATION_CACHE_DIR when set, else
# <repo>/.jax_cache (the tracking scan is expensive to compile on CPU)
from gps_sdr.utils.profiling import enable_compile_cache  # noqa: E402

enable_compile_cache()

import hashlib  # noqa: E402
import pickle  # noqa: E402
import subprocess  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

_SYNTH_CACHE = os.path.join(os.path.dirname(__file__), "..", ".synth_cache")


def cached_synth(key: str, builder):
    """Disk-cache synthesized IQ fixtures: host synthesis is slow, so
    second runs must not pay it again."""
    os.makedirs(_SYNTH_CACHE, exist_ok=True)
    h = hashlib.sha1(key.encode()).hexdigest()[:16]
    path = os.path.join(_SYNTH_CACHE, f"{h}.npy")
    if os.path.exists(path):
        return np.load(path)
    data = builder()
    np.save(path, data)
    return data


def reference_result(name: str, capture_path, *driver_args):
    """The upstream reference's outputs on a capture (tests/ref_driver.py,
    run once and pickled under .synth_cache/<name>).  Skips the calling
    test when neither the cached result nor the reference checkout
    (ref_driver.REF_SRC) exists; the agreement recorded in PARITY.md
    then stands unchecked on this machine."""
    from tests.ref_driver import REF_SRC

    out = os.path.join(_SYNTH_CACHE, name)
    if not os.path.exists(out):
        if not os.path.isdir(REF_SRC):
            pytest.skip(f"reference checkout {REF_SRC} absent and no "
                        f"cached result {name}")
        driver = os.path.join(os.path.dirname(__file__), "ref_driver.py")
        subprocess.run([sys.executable, driver, capture_path(),
                        out + ".tmp", *driver_args], check=True,
                       timeout=3600)
        os.replace(out + ".tmp", out)
    with open(out, "rb") as f:
        return pickle.load(f)
