"""Render state pytree.

The reference's full mutable renderer state is the accumulation buffer plus
the iteration counter (`dev_image` + ``iteration``, `pathtrace.cu:448`,
`main.cpp:25`). Here it is an explicit immutable pytree threaded through the
jitted step — which also makes checkpoint/resume trivial (see
render.checkpoint; the reference has no in-run persistence at all)."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.pytree import PyTreeNode


class RenderState(PyTreeNode):
    accum: jnp.ndarray  # (N, 3) f32 linear radiance sums
    iteration: jnp.ndarray  # () i32 — samples accumulated so far
    key: jnp.ndarray  # threefry base key for this render

    @classmethod
    def create(cls, num_pixels: int, seed: int = 0) -> "RenderState":
        return cls(
            accum=jnp.zeros((num_pixels, 3), jnp.float32),
            iteration=jnp.zeros((), jnp.int32),
            key=jax.random.PRNGKey(seed),
        )

    def reset(self) -> "RenderState":
        """Camera-change reset (`main.cpp:110-136`): zero the accumulator and
        the iteration counter; the RNG base key is kept."""
        return self.replace(
            accum=jnp.zeros_like(self.accum),
            iteration=jnp.zeros_like(self.iteration),
        )
