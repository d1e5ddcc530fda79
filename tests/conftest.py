"""Test harness config: the suite runs on the CPU with 8 virtual devices, so
multi-device sharding tests run anywhere (standard JAX practice). Must run
before jax is imported.

Card-only tests carry the ``gpu`` marker and take the ``gpu`` fixture, which
skips them when JAX finds no GPU. On a machine with the card they run with
``PT_TEST_DEVICE=gpu python -m pytest -m gpu tests/`` (the same checks are
phases of ``python chip_smoke.py``)."""

import os

# Force the CPU backend (JAX_PLATFORMS=cpu) unless card tests were asked for.
_ON_CARD = os.environ.get("PT_TEST_DEVICE") == "gpu"
if not _ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not _ON_CARD:
    jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache: the suite is compile-dominated (dozens of
# distinct jitted configs); repeat TARGETED runs hit the disk cache. Two
# structural guards make green runs reproducible instead of lucky:
#
# 1. FULL-SUITE runs disable the cache (see pytest_collection_finish): with
#    ~165 executables already loaded in-process, jax's cache
#    serialize/deserialize deterministically ABORTS (rc 134/139, SIGABRT in
#    native code — uncatchable) on this host, while the same entry reads
#    fine in a fresh process. A cold full-suite run compiles everything
#    regardless, so the cache only ever paid on repeat runs — not worth a
#    crash class. PT_TEST_COMPILE_CACHE=1/0 forces the policy either way.
# 2. The cache is per-session EXCLUSIVE (flock): concurrent pytest sessions
#    sharing the dir corrupt entries mid-write (a later run then aborts in
#    zstd decode of the truncated entry). A second session detects the lock
#    and simply runs uncached.
_CACHE_DIR = os.path.join(os.path.dirname(__file__), ".jax_cache")
_CACHE_POLICY = os.environ.get("PT_TEST_COMPILE_CACHE", "auto")
_cache_on = _CACHE_POLICY != "0"
_LOCK_FD = None
if _cache_on:
    import fcntl

    os.makedirs(_CACHE_DIR, exist_ok=True)
    _LOCK_FD = open(os.path.join(_CACHE_DIR, ".session_lock"), "w")
    try:
        fcntl.flock(_LOCK_FD, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except OSError:
        _cache_on = False  # another live session owns the cache dir
if _cache_on:
    jax.config.update("jax_compilation_cache_dir", _CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

# Full-suite-scale threshold: the suite has ~190 tests; the largest targeted
# multi-module dev runs stay well under this.
_FULL_SUITE_ITEMS = 120


def pytest_collection_finish(session):
    if _CACHE_POLICY == "auto" and _cache_on and len(session.items) > _FULL_SUITE_ITEMS:
        import sys

        print(
            f"conftest: {len(session.items)} tests collected (full-suite "
            "scale) — persistent compile cache disabled for this run "
            "(in-process cache serialize aborts past ~165 live "
            "executables; PT_TEST_COMPILE_CACHE=1 overrides)",
            file=sys.stderr,
        )
        jax.config.update("jax_compilation_cache_dir", None)


import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def cornell_desc():
    from cosc_4397_pathtracing_raytracing_project_tpu.scene import load_scene_desc

    return load_scene_desc(os.path.join(os.path.dirname(__file__), "..", "scenes", "cornell.txt"))


@pytest.fixture(scope="session")
def cornell_scene(cornell_desc):
    from cosc_4397_pathtracing_raytracing_project_tpu.scene import Scene

    return Scene.from_desc(cornell_desc)


@pytest.fixture(scope="session")
def sphere_desc():
    from cosc_4397_pathtracing_raytracing_project_tpu.scene import load_scene_desc

    return load_scene_desc(os.path.join(os.path.dirname(__file__), "..", "scenes", "sphere.txt"))


@pytest.fixture
def rng_np():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """The first JAX device when it is a GPU; skips the test otherwise.
    Decided here, when the test runs — never at import or collection, so
    every xdist worker collects the same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(
            f"needs an NVIDIA GPU (JAX found {dev.platform}); run "
            "`python chip_smoke.py` or `PT_TEST_DEVICE=gpu pytest -m gpu` "
            "on the card"
        )
    return dev
