"""Golden tests for the L0 math layer against independent formulas."""
import jax.numpy as jnp
import numpy as np
import pytest

from mupe_tpu.core import (
    cpos,
    euler_to_quaternion,
    off_diag,
    quat_axis,
    quat_mul,
    quat_rotate,
    quat_rotate_inverse,
    quaternion_to_euler,
    quaternion_to_rotation_matrix,
)


def random_quat(rng, shape=()):
    q = rng.normal(size=shape + (4,))
    return jnp.asarray(q / np.linalg.norm(q, axis=-1, keepdims=True))


def test_quat_rotate_matches_matrix():
    rng = np.random.default_rng(0)
    q = random_quat(rng, (32,))
    v = jnp.asarray(rng.normal(size=(32, 3)))
    r = quaternion_to_rotation_matrix(q)
    np.testing.assert_allclose(
        quat_rotate(q, v), jnp.einsum("bij,bj->bi", r, v), atol=1e-5
    )
    np.testing.assert_allclose(
        quat_rotate_inverse(q, v), jnp.einsum("bji,bj->bi", r, v), atol=1e-5
    )


def test_quat_mul_composes_rotation():
    rng = np.random.default_rng(1)
    q1, q2 = random_quat(rng, (8,)), random_quat(rng, (8,))
    v = jnp.asarray(rng.normal(size=(8, 3)))
    np.testing.assert_allclose(
        quat_rotate(quat_mul(q1, q2), v),
        quat_rotate(q1, quat_rotate(q2, v)),
        atol=1e-5,
    )


def test_euler_round_trip():
    rng = np.random.default_rng(2)
    rpy = jnp.asarray(rng.uniform(-1.0, 1.0, size=(16, 3)))
    q = euler_to_quaternion(rpy)
    np.testing.assert_allclose(quaternion_to_euler(q), rpy, atol=1e-5)


def test_euler_to_quaternion_yaw_only():
    # yaw of pi/2 about z
    q = euler_to_quaternion(jnp.asarray([0.0, 0.0, np.pi / 2]))
    v = quat_rotate(q, jnp.asarray([1.0, 0.0, 0.0]))
    np.testing.assert_allclose(v, [0.0, 1.0, 0.0], atol=1e-6)


def test_quat_axis_identity():
    q = jnp.asarray([1.0, 0.0, 0.0, 0.0])
    np.testing.assert_allclose(quat_axis(q, 0), [1.0, 0.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(quat_axis(q, 2), [0.0, 0.0, 1.0], atol=1e-6)


def test_off_diag_and_cpos():
    a = jnp.arange(9).reshape(3, 3)
    od = off_diag(a[..., None])
    # row i keeps every column except i
    np.testing.assert_array_equal(od[:, :, 0], [[1, 2], [3, 5], [6, 7]])
    p = jnp.asarray([[0.0, 0.0], [1.0, 0.0]])
    rel = cpos(p, p)
    np.testing.assert_allclose(rel[1, 0], [1.0, 0.0])


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_quat_axis_matches_matrix_column(axis):
    rng = np.random.default_rng(3)
    q = random_quat(rng, (5,))
    r = quaternion_to_rotation_matrix(q)
    np.testing.assert_allclose(quat_axis(q, axis), r[..., :, axis], atol=1e-5)


# ------------------------------------------------------------ core.struct
def _point_cls():
    from mupe_tpu.core import struct

    @struct.dataclass
    class Point:
        x: jnp.ndarray
        y: jnp.ndarray = None
        tag: str = struct.field(pytree_node=False, default="p")

    return Point


def test_struct_replace_returns_new_frozen_instance():
    import dataclasses

    point = _point_cls()(x=jnp.ones(2), y=jnp.zeros(2))
    moved = point.replace(x=jnp.full(2, 3.0))
    np.testing.assert_array_equal(np.asarray(point.x), 1.0)
    np.testing.assert_array_equal(np.asarray(moved.x), 3.0)
    assert moved.tag == "p" and moved.y is point.y
    with pytest.raises(dataclasses.FrozenInstanceError):
        point.x = jnp.zeros(2)


def test_struct_static_field_is_treedef_metadata():
    import jax

    Point = _point_cls()
    a, b = Point(x=jnp.ones(2), tag="a"), Point(x=jnp.ones(2), tag="b")
    # only array fields are leaves (None is an empty subtree)
    assert len(jax.tree_util.tree_leaves(a)) == 1
    assert jax.tree_util.tree_structure(a) != jax.tree_util.tree_structure(b)
    # the static value reaches jitted code as a Python constant
    f = jax.jit(lambda p: p.x * (2.0 if p.tag == "b" else 1.0))
    np.testing.assert_array_equal(np.asarray(f(b)), 2.0)
    np.testing.assert_array_equal(np.asarray(f(a)), 1.0)


def test_struct_pytree_round_trip_through_jit_and_tree_map():
    import jax

    Point = _point_cls()
    p = Point(x=jnp.arange(3.0), y=jnp.ones(3), tag="z")
    leaves, treedef = jax.tree_util.tree_flatten(p)
    q = jax.tree_util.tree_unflatten(treedef, leaves)
    assert type(q) is Point and q.tag == "z"
    r = jax.jit(lambda t: jax.tree_util.tree_map(lambda v: v + 1.0, t))(p)
    assert type(r) is Point and r.tag == "z"
    np.testing.assert_array_equal(np.asarray(r.x), [1.0, 2.0, 3.0])
    np.testing.assert_array_equal(np.asarray(r.y), 2.0)
