"""Where the persistent XLA compilation cache lives.

One rule for every script of the checkout (bench.py, chip_smoke.py,
__graft_entry__.py, scripts/bench_*.py):

- ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads the variable itself, and no
  other directory is set in code;
- otherwise: ``.jax_cache/`` at the root of the checkout — a fixed path,
  since the path is part of the cache key and a moving directory never hits.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(CHECKOUT_ROOT, ".jax_cache")


def cache_dir_to_set(environ: Optional[Mapping[str, str]] = None) -> Optional[str]:
    """The directory code must configure: None when the environment
    variable already names one, else the checkout's ``.jax_cache/``."""
    environ = os.environ if environ is None else environ
    return None if environ.get(ENV_VAR) else DEFAULT_DIR


def enable_compile_cache() -> str:
    """Turn the persistent cache on per the module rule; returns the
    directory in use."""
    import jax

    path = cache_dir_to_set()
    if path is None:
        return os.environ[ENV_VAR]
    jax.config.update("jax_compilation_cache_dir", path)
    return path
