"""SE(3) Lee position / attitude / body-rate controllers, pure JAX.

Ports of the reference controller family
(omni_drones/controllers/lee_position_controller.py:41-433) to stateless
functions.  The mixer maps desired [angular acceleration, thrust] to rotor
commands through the pseudo-inverse of the allocation matrix scaled by the
inertia (compute_parameters, lee_position_controller.py:41-61).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from ..core import (
    axis_angle_to_quaternion,
    quat_rotate_inverse,
    quaternion_to_euler,
    quaternion_to_rotation_matrix,
)
from ..core.math import einsum, matmul, normalize
from .pid_rate import PIDRateState, pid_rate_control  # noqa: F401  (re-export)
from ..dynamics.params import DRONE_ZOO

# Lee controller gains per drone model
# (reference: omni_drones/controllers/cfg/lee_controller_*.yaml)
LEE_GAINS = {
    "hummingbird": dict(
        position_gain=(4.0, 4.0, 4.0),
        velocity_gain=(2.2, 2.2, 2.2),
        attitude_gain=(0.7, 0.7, 0.035),
        angular_rate_gain=(0.1, 0.1, 0.025),
    ),
    "firefly": dict(
        position_gain=(6.0, 6.0, 6.0),
        velocity_gain=(4.7, 4.7, 4.7),
        attitude_gain=(3.0, 3.0, 0.15),
        angular_rate_gain=(0.52, 0.52, 0.18),
    ),
    "neo11": dict(
        position_gain=(8.0, 8.0, 17.0),
        velocity_gain=(6.0, 6.0, 10.0),
        attitude_gain=(4.0, 4.0, 2.0),
        angular_rate_gain=(0.7, 0.7, 0.7),
    ),
    # The reference ships no Lee gains for the crazyflie (it uses the PID rate
    # path); hummingbird-style gains scaled for the small platform.
    "crazyflie": dict(
        position_gain=(4.0, 4.0, 4.0),
        velocity_gain=(2.2, 2.2, 2.2),
        attitude_gain=(0.7, 0.7, 0.035),
        angular_rate_gain=(0.1, 0.1, 0.025),
    ),
}


class MixerParams(NamedTuple):
    """Static controller constants precomputed on host with numpy."""

    mixer: jnp.ndarray            # (R, 4)
    max_thrusts: jnp.ndarray      # (R,)
    mass: float
    inertia: jnp.ndarray          # (3,)
    pos_gain: jnp.ndarray
    vel_gain: jnp.ndarray
    att_gain: jnp.ndarray         # already divided by inertia
    rate_gain: jnp.ndarray        # already divided by inertia


def make_mixer(model: str = "crazyflie") -> MixerParams:
    """Precompute the allocation mixer (lee_position_controller.py:41-61)."""
    cfg = DRONE_ZOO[model if model in DRONE_ZOO else "crazyflie"]
    r = cfg["num_rotors"]
    angles = np.asarray(cfg["rotor_angles"], dtype=np.float64)
    arm = float(cfg["arm_length"])
    fc = np.full((r,), cfg["force_constants"])
    mc = np.full((r,), cfg["moment_constants"])
    dirs = np.asarray(cfg["directions"], dtype=np.float64)
    a = np.stack(
        [
            np.sin(angles) * arm,
            -np.cos(angles) * arm,
            -dirs * mc / fc,
            np.ones_like(angles),
        ]
    )
    inertia = np.asarray(cfg["inertia"], dtype=np.float64)
    i4 = np.diag(np.concatenate([inertia, [1.0]]))
    mixer = a.T @ np.linalg.inv(a @ a.T) @ i4
    omega_max = np.full((r,), cfg["max_rotation_velocities"])
    max_thrusts = omega_max**2 * fc
    gains = LEE_GAINS.get(model, LEE_GAINS["crazyflie"])
    inv_i = 1.0 / inertia
    return MixerParams(
        mixer=jnp.asarray(mixer, jnp.float32),
        max_thrusts=jnp.asarray(max_thrusts, jnp.float32),
        mass=float(cfg["mass"]),
        inertia=jnp.asarray(inertia, jnp.float32),
        pos_gain=jnp.asarray(gains["position_gain"], jnp.float32),
        vel_gain=jnp.asarray(gains["velocity_gain"], jnp.float32),
        att_gain=jnp.asarray(np.asarray(gains["attitude_gain"]) * inv_i, jnp.float32),
        rate_gain=jnp.asarray(
            np.asarray(gains["angular_rate_gain"]) * inv_i, jnp.float32
        ),
    )


def _mix(mp: MixerParams, ang_acc: jnp.ndarray, thrust: jnp.ndarray) -> jnp.ndarray:
    """[ang_acc(3), thrust(1)] → normalized rotor cmds in [-1, 1]
    (lee_position_controller.py:200-203)."""
    angacc_thrust = jnp.concatenate([ang_acc, thrust], axis=-1)
    cmd = matmul(angacc_thrust, mp.mixer.T)
    return (cmd / mp.max_thrusts) * 2.0 - 1.0


def lee_position_control(
    mp: MixerParams,
    pos: jnp.ndarray,
    quat: jnp.ndarray,
    vel: jnp.ndarray,
    angvel_w: jnp.ndarray,
    target_pos: jnp.ndarray,
    target_vel: Optional[jnp.ndarray] = None,
    target_acc: Optional[jnp.ndarray] = None,
    target_yaw: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Geometric SE(3) position control (lee_position_controller.py:156-203)."""
    ang_vel = quat_rotate_inverse(quat, angvel_w)
    if target_vel is None:
        target_vel = jnp.zeros_like(vel)
    if target_acc is None:
        target_acc = jnp.zeros_like(vel)
    if target_yaw is None:
        target_yaw = quaternion_to_euler(quat)[..., -1:]

    pos_error = pos - target_pos
    vel_error = vel - target_vel
    g = jnp.asarray([0.0, 0.0, 9.81], dtype=pos.dtype)
    acc = pos_error * mp.pos_gain + vel_error * mp.vel_gain - g - target_acc
    rmat = quaternion_to_rotation_matrix(quat)
    b1_des = jnp.concatenate(
        [jnp.cos(target_yaw), jnp.sin(target_yaw), jnp.zeros_like(target_yaw)],
        axis=-1,
    )
    b3_des = -normalize(acc)
    b2_des = normalize(jnp.cross(b3_des, b1_des))
    r_des = jnp.stack([jnp.cross(b2_des, b3_des), b2_des, b3_des], axis=-1)
    err_mat = 0.5 * (
        matmul(jnp.swapaxes(r_des, -1, -2), rmat)
        - matmul(jnp.swapaxes(rmat, -1, -2), r_des)
    )
    ang_error = jnp.stack(
        [err_mat[..., 2, 1], err_mat[..., 0, 2], err_mat[..., 1, 0]], axis=-1
    )
    ang_acc = -ang_error * mp.att_gain - ang_vel * mp.rate_gain
    thrust = -mp.mass * jnp.sum(acc * rmat[..., :, 2], axis=-1, keepdims=True)
    return _mix(mp, ang_acc, thrust)


def attitude_control(
    mp: MixerParams,
    quat: jnp.ndarray,
    angvel_w: jnp.ndarray,
    target_thrust: jnp.ndarray,
    target_yaw_rate: jnp.ndarray,
    target_roll: jnp.ndarray,
    target_pitch: jnp.ndarray,
    att_gain=(3.0, 3.0, 0.035),
    rate_gain=(0.52, 0.52, 0.025),
) -> jnp.ndarray:
    """Thrust + roll/pitch/yaw-rate attitude control
    (lee_position_controller.py:206-300).  Gains follow the reference's
    hard-coded AttitudeController values divided by inertia."""
    rmat = quaternion_to_rotation_matrix(quat)
    yaw = jnp.arctan2(rmat[..., 1, 0], rmat[..., 0, 0])[..., None]
    z = jnp.asarray([0.0, 0.0, 1.0], quat.dtype)
    x = jnp.asarray([1.0, 0.0, 0.0], quat.dtype)
    y = jnp.asarray([0.0, 1.0, 0.0], quat.dtype)
    q_yaw = axis_angle_to_quaternion(yaw, jnp.broadcast_to(z, yaw.shape[:-1] + (3,)))
    q_roll = axis_angle_to_quaternion(
        target_roll, jnp.broadcast_to(x, target_roll.shape[:-1] + (3,))
    )
    q_pitch = axis_angle_to_quaternion(
        target_pitch, jnp.broadcast_to(y, target_pitch.shape[:-1] + (3,))
    )
    r_des = matmul(
        matmul(
            quaternion_to_rotation_matrix(q_yaw),
            quaternion_to_rotation_matrix(q_roll),
        ),
        quaternion_to_rotation_matrix(q_pitch),
    )
    err_mat = 0.5 * (
        matmul(jnp.swapaxes(r_des, -1, -2), rmat)
        - matmul(jnp.swapaxes(rmat, -1, -2), r_des)
    )
    ang_error = jnp.stack(
        [err_mat[..., 2, 1], err_mat[..., 0, 2], jnp.zeros_like(err_mat[..., 0, 0])],
        axis=-1,
    )
    rate_des = jnp.concatenate(
        [jnp.zeros_like(target_yaw_rate), jnp.zeros_like(target_yaw_rate), target_yaw_rate],
        axis=-1,
    )
    rel = matmul(jnp.swapaxes(r_des, -1, -2), rmat)
    rate_err = angvel_w - einsum("...ij,...j->...i", rel, rate_des)
    inv_i = 1.0 / mp.inertia
    ang_acc = (
        -ang_error * jnp.asarray(att_gain, quat.dtype) * inv_i
        - rate_err * jnp.asarray(rate_gain, quat.dtype) * inv_i
    )
    return _mix(mp, ang_acc, target_thrust)


def rate_control(
    mp: MixerParams,
    quat: jnp.ndarray,
    angvel_w: jnp.ndarray,
    target_rate: jnp.ndarray,
    target_thrust: jnp.ndarray,
    gain=(0.0052, 0.0052, 0.00025),
) -> jnp.ndarray:
    """Proportional body-rate controller (lee_position_controller.py:303-406).

    Default gain is the crazyflie ``controller_configuration.gain``
    (crazyflie.yaml:54-58) divided by inertia, as in the reference.
    """
    body_rate = quat_rotate_inverse(quat, angvel_w)
    rate_error = body_rate - target_rate
    inv_i = 1.0 / mp.inertia
    ang_acc = -rate_error * jnp.asarray(gain, quat.dtype) * inv_i + jnp.cross(
        angvel_w, angvel_w
    )
    return _mix(mp, ang_acc, target_thrust)
