"""utils.pytree: the frozen dataclass pytree base of every device struct."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cosc_4397_pathtracing_raytracing_project_tpu.utils.pytree import (
    PyTreeNode,
    field,
)


class _Node(PyTreeNode):
    a: jnp.ndarray
    shape: tuple = field(static=True, default=(2, 3))
    b: jnp.ndarray = field(default_factory=lambda: jnp.zeros(()))


def test_flatten_unflatten_roundtrip():
    node = _Node(a=jnp.arange(3.0), shape=(4, 5), b=jnp.ones(()))
    leaves, treedef = jax.tree_util.tree_flatten(node)
    assert len(leaves) == 2  # a and b; the static field is not a leaf
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(back, _Node) and back.shape == (4, 5)
    np.testing.assert_array_equal(back.a, node.a)


def test_static_field_lives_in_the_treedef():
    x = _Node(a=jnp.zeros(2), shape=(1, 1))
    y = _Node(a=jnp.zeros(2), shape=(2, 2))
    assert jax.tree_util.tree_structure(x) != jax.tree_util.tree_structure(y)
    # under jit a static field stays a Python value (usable as a shape)
    out = jax.jit(lambda n: jnp.zeros(n.shape) + n.a.sum())(x)
    assert out.shape == (1, 1)


def test_replace_and_frozen():
    node = _Node(a=jnp.zeros(2))
    new = node.replace(a=jnp.ones(2))
    assert new is not node
    np.testing.assert_array_equal(node.a, 0.0)
    np.testing.assert_array_equal(new.a, 1.0)
    assert new.shape == node.shape
    with pytest.raises(dataclasses.FrozenInstanceError):
        node.a = jnp.ones(2)


def test_scene_structs_are_pytrees(cornell_scene):
    leaves = jax.tree_util.tree_leaves(cornell_scene)
    assert all(isinstance(x, jax.Array) for x in leaves)
    cam = cornell_scene.camera
    # resolution is static: jit sees a tuple, not a traced value
    res = jax.jit(lambda s: jnp.zeros(s.camera.resolution))(cornell_scene)
    assert res.shape == tuple(cam.resolution)
