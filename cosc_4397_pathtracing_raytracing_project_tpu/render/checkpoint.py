"""Checkpoint / resume.

The reference has no in-run persistence — its only output is the terminal
PNG (`main.cpp:86-107`). Here the accumulation buffer + iteration counter +
RNG key *is* the complete renderer state (`render.state.RenderState`), so
checkpointing is a single npz: a resumed render continues the exact sample
sequence (iteration indices key the RNG), making save/resume bit-identical
to an uninterrupted run."""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import jax.numpy as jnp

from .state import RenderState

_FORMAT_VERSION = 1


def save_checkpoint(path: str, state: RenderState, meta: Optional[dict] = None) -> str:
    if not path.endswith(".npz"):
        path = path + ".npz"
    tmp = path + ".tmp"
    np.savez_compressed(
        tmp,
        version=np.int32(_FORMAT_VERSION),
        accum=np.asarray(state.accum),
        iteration=np.asarray(state.iteration),
        key=np.asarray(state.key),
        meta=json.dumps(meta or {}),
    )
    # numpy appends .npz to the temp name
    os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)
    return path


def load_checkpoint(path: str):
    """Returns (RenderState, meta dict)."""
    with np.load(path, allow_pickle=False) as data:
        version = int(data["version"])
        if version > _FORMAT_VERSION:
            raise ValueError(f"checkpoint version {version} is newer than supported")
        if "acc_a" in data:
            raise ValueError(
                "this is an adaptive-sampling checkpoint — load it with "
                "AdaptiveRenderer.load_checkpoint"
            )
        state = RenderState(
            accum=jnp.asarray(data["accum"]),
            iteration=jnp.asarray(data["iteration"]),
            key=jnp.asarray(data["key"]),
        )
        meta = json.loads(str(data["meta"]))
    return state, meta


# ── adaptive-sampler state (render.adaptive) ──
#
# The adaptive renderer's complete state is the two half-buffer
# accumulators + per-tile sample counts + RNG key + the lane-budget odometer:
# per-tile iteration counters fully key every RNG/LD stream, so a resumed
# adaptive render continues each tile's sample sequence exactly where it
# stopped — save/resume is bit-identical, same contract as the uniform
# path above.

def save_adaptive_checkpoint(path: str, r, meta: Optional[dict] = None) -> str:
    if not path.endswith(".npz"):
        path = path + ".npz"
    tmp = path + ".tmp"
    np.savez_compressed(
        tmp,
        version=np.int32(_FORMAT_VERSION),
        acc_a=np.asarray(r._acc_a),
        acc_b=np.asarray(r._acc_b),
        counts=np.asarray(r._counts),
        key=np.asarray(r._key),
        budget_spent=np.int64(r._lane_budget_spent),
        meta=json.dumps(meta or {}),
    )
    os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)
    return path


def load_adaptive_checkpoint(path: str):
    """Returns (state dict, meta dict) for AdaptiveRenderer.load_checkpoint."""
    with np.load(path, allow_pickle=False) as data:
        version = int(data["version"])
        if version > _FORMAT_VERSION:
            raise ValueError(f"checkpoint version {version} is newer than supported")
        if "acc_a" not in data:
            raise ValueError(
                "this is a uniform-render checkpoint — load it with "
                "Renderer.load_checkpoint"
            )
        state = {
            "acc_a": jnp.asarray(data["acc_a"]),
            "acc_b": jnp.asarray(data["acc_b"]),
            "counts": jnp.asarray(data["counts"]),
            "key": jnp.asarray(data["key"]),
            "budget_spent": int(data["budget_spent"]),
        }
        meta = json.loads(str(data["meta"]))
    return state, meta
