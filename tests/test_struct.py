"""utils/struct.py: frozen pytree dataclasses with static fields."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest

from altro_mpc.utils import struct


@struct.dataclass
class _Point:
    x: jnp.ndarray
    y: jnp.ndarray = struct.field(default=None)
    tag: str = struct.field(pytree_node=False, default="a")


def test_pytree_round_trip():
    p = _Point(x=jnp.arange(3.0), y=jnp.ones(2), tag="b")
    leaves, treedef = jax.tree_util.tree_flatten(p)
    q = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(q, _Point) and q.tag == "b"
    assert jnp.array_equal(q.x, p.x) and jnp.array_equal(q.y, p.y)
    # through jit and vmap
    r = jax.jit(lambda p: p.replace(x=p.x * 2))(p)
    assert jnp.array_equal(r.x, 2 * p.x) and r.tag == "b"
    v = jax.vmap(lambda p: p.x + p.y[0])(
        _Point(x=jnp.ones((4, 3)), y=jnp.ones((4, 2))))
    assert v.shape == (4, 3)


def test_replace_and_frozen():
    p = _Point(x=jnp.zeros(2))
    q = p.replace(tag="c", y=jnp.ones(1))
    assert (p.tag, p.y) == ("a", None) and q.tag == "c"
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.x = jnp.ones(2)


def test_static_fields_not_leaves():
    p = _Point(x=jnp.zeros(2), y=jnp.zeros(1), tag="s")
    assert len(jax.tree_util.tree_leaves(p)) == 2
    # static fields are part of the structure: a different tag is a
    # different treedef (and a retrace under jit)
    t1 = jax.tree_util.tree_structure(p)
    t2 = jax.tree_util.tree_structure(p.replace(tag="t"))
    assert t1 != t2
