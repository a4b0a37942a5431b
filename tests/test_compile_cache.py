"""Persistent compile cache placement: JAX_COMPILATION_CACHE_DIR when
set (left alone, no other path set), else the fixed <repo>/.jax_cache."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROG = """
import jax, jax.numpy as jnp
from gps_sdr.utils.profiling import enable_compile_cache
path = enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.jit(lambda x: jnp.sin(x) * 3.0 + 1.0)(jnp.ones(7)).block_until_ready()
print(path)
print(jax.config.jax_compilation_cache_dir)
"""


def _run(env_extra):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO, **env_extra)
    r = subprocess.run([sys.executable, "-c", PROG], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       check=True)
    return r.stdout.split()


def test_cache_follows_environment(tmp_path):
    target = str(tmp_path / "cc")
    path, cfg_dir = _run({"JAX_COMPILATION_CACHE_DIR": target})
    assert path == target and cfg_dir == target
    assert os.listdir(target)              # the compile landed there


def test_cache_defaults_to_repo_dir():
    path, cfg_dir = _run({})
    assert path == cfg_dir == os.path.join(REPO, ".jax_cache")
