"""The accelerator a measurement runs on.

A device metric names its device: JAX's platform, ``device_kind`` and
device count, plus the card's name and power limit as ``nvidia-smi``
reports them (a card set below its maximum power runs slower under load).
A measurement path that finds no GPU fails; it never falls back to the CPU.
"""

from __future__ import annotations

import subprocess
from typing import List


def require_gpu():
    """The first JAX device; raises RuntimeError unless it is a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {dev.platform} "
            f"({dev.device_kind}); device metrics need the card"
        )
    return dev


def device_record() -> dict:
    """``{"platform", "kind", "count"}`` of JAX's devices."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def card_lines() -> List[str]:
    """One ``name, power.limit`` line per GPU, from ``nvidia-smi`` in a
    child process (which stays off JAX). On failure, one line saying why."""
    cmd = [
        "nvidia-smi",
        "--query-gpu=name,power.limit",
        "--format=csv,noheader",
    ]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"nvidia-smi unavailable: {e}"]
    lines = [ln.strip() for ln in res.stdout.splitlines() if ln.strip()]
    if res.returncode != 0 or not lines:
        return [f"nvidia-smi failed (rc {res.returncode})"]
    return lines
