"""Quaternion math (w, x, y, z convention), pure jax.numpy.

JAX counterpart of the reference's torch quaternion suite
(reference: omni_drones/utils/torch.py:60-258).  All functions broadcast over
arbitrary leading batch dimensions — no manual reshaping is needed, which lets
them be used freely inside ``vmap``/``scan`` without the reference's
``manual_batch`` wrapper.
"""
from __future__ import annotations

import jax.numpy as jnp


def quat_mul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product of two (..., 4) wxyz quaternions."""
    w1, x1, y1, z1 = jnp.moveaxis(a, -1, 0)
    w2, x2, y2, z2 = jnp.moveaxis(b, -1, 0)
    return jnp.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def quat_conjugate(q: jnp.ndarray) -> jnp.ndarray:
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_rotate(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate vectors ``v`` (..., 3) by quaternions ``q`` (..., 4).

    Matches omni_drones/utils/torch.py:185-194 (`quat_rotate`).
    """
    q_w = q[..., :1]
    q_vec = q[..., 1:]
    a = v * (2.0 * q_w**2 - 1.0)
    b = jnp.cross(q_vec, v) * q_w * 2.0
    c = q_vec * jnp.sum(q_vec * v, axis=-1, keepdims=True) * 2.0
    return a + b + c


def quat_rotate_inverse(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate ``v`` by the inverse of ``q`` (world→body for a body→world q)."""
    q_w = q[..., :1]
    q_vec = q[..., 1:]
    a = v * (2.0 * q_w**2 - 1.0)
    b = jnp.cross(q_vec, v) * q_w * 2.0
    c = q_vec * jnp.sum(q_vec * v, axis=-1, keepdims=True) * 2.0
    return a - b + c


def quat_axis(q: jnp.ndarray, axis: int = 0) -> jnp.ndarray:
    """The world-frame direction of a body basis axis (0=x/heading, 2=z/up)."""
    basis = jnp.zeros(3, dtype=q.dtype).at[axis].set(1.0)
    return quat_rotate(q, jnp.broadcast_to(basis, q.shape[:-1] + (3,)))


def euler_to_quaternion(rpy: jnp.ndarray) -> jnp.ndarray:
    """Roll-pitch-yaw (XYZ intrinsic) → wxyz quaternion.

    Matches omni_drones/utils/torch.py:110-127 (`euler_to_quaternion`).
    """
    r, p, y = jnp.moveaxis(rpy, -1, 0)
    cy, sy = jnp.cos(y * 0.5), jnp.sin(y * 0.5)
    cp, sp = jnp.cos(p * 0.5), jnp.sin(p * 0.5)
    cr, sr = jnp.cos(r * 0.5), jnp.sin(r * 0.5)
    return jnp.stack(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        axis=-1,
    )


def quaternion_to_euler(q: jnp.ndarray) -> jnp.ndarray:
    """wxyz quaternion → roll-pitch-yaw (reference utils/torch.py:92-107)."""
    w, x, y, z = jnp.moveaxis(q, -1, 0)
    roll = jnp.arctan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = jnp.arcsin(jnp.clip(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = jnp.arctan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return jnp.stack([roll, pitch, yaw], axis=-1)


def quaternion_to_rotation_matrix(q: jnp.ndarray) -> jnp.ndarray:
    """wxyz quaternion → (..., 3, 3) rotation matrix."""
    w, x, y, z = jnp.moveaxis(q, -1, 0)
    tx, ty, tz = 2.0 * x, 2.0 * y, 2.0 * z
    twx, twy, twz = tx * w, ty * w, tz * w
    txx, txy, txz = tx * x, ty * x, tz * x
    tyy, tyz, tzz = ty * y, tz * y, tz * z
    m = jnp.stack(
        [
            1.0 - (tyy + tzz), txy - twz, txz + twy,
            txy + twz, 1.0 - (txx + tzz), tyz - twx,
            txz - twy, tyz + twx, 1.0 - (txx + tyy),
        ],
        axis=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def axis_angle_to_quaternion(angle: jnp.ndarray, axis: jnp.ndarray) -> jnp.ndarray:
    axis = axis / jnp.linalg.norm(axis, axis=-1, keepdims=True)
    return jnp.concatenate(
        [jnp.cos(angle / 2.0), jnp.sin(angle / 2.0) * axis], axis=-1
    )


def quat_normalize(q: jnp.ndarray, eps: float = 1e-9) -> jnp.ndarray:
    return q / (jnp.linalg.norm(q, axis=-1, keepdims=True) + eps)


def quat_integrate(q: jnp.ndarray, omega_world: jnp.ndarray, dt: float) -> jnp.ndarray:
    """Integrate a wxyz quaternion by a world-frame angular velocity for dt.

    q(t+dt) = normalize(q + 0.5 * dt * [0, ω_w] ⊗ q) — the same first-order
    update PhysX uses for rigid-body rotation.
    """
    omega_quat = jnp.concatenate(
        [jnp.zeros_like(omega_world[..., :1]), omega_world], axis=-1
    )
    dq = 0.5 * dt * quat_mul(omega_quat, q)
    return quat_normalize(q + dq)
