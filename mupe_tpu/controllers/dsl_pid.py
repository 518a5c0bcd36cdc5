"""gym-pybullet-drones-style DSL PID position controller, pure JAX.

Port of the reference ``DSLPIDController``
(omni_drones/controllers/dsl_pid_controller.py:31-131): cascaded
position→attitude PID with PWM mixing, the default controller of the
reference's Crazyflie class.  Controller state is an explicit pytree; all
math broadcasts over leading batch dims.
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from ..core import struct
from ..core import quaternion_to_euler, quaternion_to_rotation_matrix
from ..core.math import einsum, matmul, normalize

P_COEFF_FOR = (0.4, 0.4, 1.25)
I_COEFF_FOR = (0.05, 0.05, 0.05)
D_COEFF_FOR = (0.2, 0.2, 0.5)
P_COEFF_TOR = (70000.0, 70000.0, 60000.0)
I_COEFF_TOR = (0.0, 0.0, 500.0)
D_COEFF_TOR = (20000.0, 20000.0, 12000.0)
PWM2RPM_SCALE = 0.2685
PWM2RPM_CONST = 4070.3
MIN_PWM, MAX_PWM = 20000.0, 65535.0
KF = 3.16e-10
MAX_RPM = 21714.0
MIXER_MATRIX = (
    (-0.5, -0.5, 1.0),
    (-0.5, 0.5, -1.0),
    (0.5, 0.5, 1.0),
    (0.5, -0.5, -1.0),
)


@struct.dataclass
class DSLPIDState:
    integral_pos_error: jnp.ndarray  # (..., 3)
    integral_rpy_error: jnp.ndarray  # (..., 3)
    last_rpy: jnp.ndarray            # (..., 3)

    @classmethod
    def zeros(cls, batch_shape: Tuple[int, ...], dtype=jnp.float32) -> "DSLPIDState":
        z = jnp.zeros(batch_shape + (3,), dtype)
        return cls(integral_pos_error=z, integral_rpy_error=z, last_rpy=z)


def dsl_pid_control(
    pos: jnp.ndarray,
    quat: jnp.ndarray,
    vel: jnp.ndarray,
    target_pos: jnp.ndarray,
    target_vel: jnp.ndarray,
    target_yaw: jnp.ndarray,
    state: DSLPIDState,
    dt: float,
    mass: float = 0.0321,
) -> Tuple[jnp.ndarray, DSLPIDState]:
    """One DSL PID tick → rotor cmds in [-1, 1] (dsl_pid_controller.py:65-131)."""
    dtype = pos.dtype
    rpy = quaternion_to_euler(quat)
    rot = quaternion_to_rotation_matrix(quat)
    gravity = jnp.asarray([0.0, 0.0, 9.81 * mass], dtype)

    pos_error = target_pos - pos
    vel_error = target_vel - vel
    integral_pos_error = jnp.clip(
        state.integral_pos_error + pos_error * dt, -2.0, 2.0
    )
    target_thrust = (
        jnp.asarray(P_COEFF_FOR, dtype) * pos_error
        + jnp.asarray(I_COEFF_FOR, dtype) * integral_pos_error
        + jnp.asarray(D_COEFF_FOR, dtype) * vel_error
        + gravity
    )
    scalar_thrust = jnp.sum(target_thrust * rot[..., :, 2], axis=-1, keepdims=True)

    target_x_c = jnp.concatenate(
        [jnp.cos(target_yaw), jnp.sin(target_yaw), jnp.zeros_like(target_yaw)],
        axis=-1,
    )
    target_z = normalize(target_thrust)
    target_y = normalize(jnp.cross(target_z, target_x_c))
    target_x = jnp.cross(target_y, target_z)
    target_rot = jnp.stack([target_x, target_y, target_z], axis=-1)
    err_mat = matmul(jnp.swapaxes(target_rot, -1, -2), rot) - matmul(
        jnp.swapaxes(rot, -1, -2), target_rot
    )
    rot_error = jnp.stack(
        [err_mat[..., 2, 1], err_mat[..., 0, 2], err_mat[..., 1, 0]], axis=-1
    )
    rpy_rates_error = -(rpy - state.last_rpy) / dt
    integral_rpy_error = state.integral_rpy_error - rot_error * dt
    target_torque = (
        -jnp.asarray(P_COEFF_TOR, dtype) * rot_error
        + jnp.asarray(D_COEFF_TOR, dtype) * rpy_rates_error
        + jnp.asarray(I_COEFF_TOR, dtype) * integral_rpy_error
    )
    thrust_pwm = (
        jnp.sqrt(jnp.clip(scalar_thrust, 0.0, None) / (4.0 * KF)) - PWM2RPM_CONST
    ) / PWM2RPM_SCALE
    mixer = jnp.asarray(MIXER_MATRIX, dtype)
    pwm = jnp.clip(
        thrust_pwm + einsum("rk,...k->...r", mixer, target_torque), 0.0, 65535.0
    )
    rpms = PWM2RPM_SCALE * pwm + PWM2RPM_CONST
    cmds = jnp.square(rpms / MAX_RPM) * 2.0 - 1.0
    new_state = DSLPIDState(
        integral_pos_error=integral_pos_error,
        integral_rpy_error=integral_rpy_error,
        last_rpy=rpy,
    )
    return cmds, new_state
