"""Crazyflie-firmware-style body-rate PID controller (the paper's controller).

Pure-function port of the reference ``PIDRateController``
(omni_drones/controllers/lee_position_controller.py:435-550): a per-axis PID
on body rates in *degrees/s*, PWM-style mixing onto 4 motors, and integrator
state that resets on episode done.  The mutable controller state lives in an
explicit `PIDRateState` pytree carried through the environment state, instead
of the reference's lazily-initialized module attributes
(lee_position_controller.py:497-502).
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from ..core import struct
from ..core import quat_rotate_inverse

# Firmware PID constants (lee_position_controller.py:448-454)
PID_KP = (250.0, 250.0, 120.0)
PID_KI = (500.0, 500.0, 16.7)
PID_KD = (2.5, 2.5, 0.0)
PID_KFF = (0.0, 0.0, 0.0)
I_LIMIT = (33.3, 33.3, 166.7)
OUT_LIMIT = 2.0**15 - 1.0


@struct.dataclass
class PIDRateState:
    """Carry state of the rate PID: integral term and previous body rate."""

    integ: jnp.ndarray           # (..., 3) accumulated rate error [deg]
    last_body_rate: jnp.ndarray  # (..., 3) previous body rate [deg/s]

    @classmethod
    def zeros(cls, batch_shape: Tuple[int, ...], dtype=jnp.float32) -> "PIDRateState":
        return cls(
            integ=jnp.zeros(batch_shape + (3,), dtype),
            last_body_rate=jnp.zeros(batch_shape + (3,), dtype),
        )

    def reset_where(self, mask: jnp.ndarray) -> "PIDRateState":
        """Zero the carry for entries where ``mask`` (broadcastable, bool) is set
        — the `reset_pid` path of lee_position_controller.py:501-502."""
        m = mask[..., None] if mask.ndim == self.integ.ndim - 1 else mask
        return PIDRateState(
            integ=jnp.where(m, 0.0, self.integ),
            last_body_rate=jnp.where(m, 0.0, self.last_body_rate),
        )


def pid_rate_control(
    quat: jnp.ndarray,
    angvel_w: jnp.ndarray,
    target_rate_deg: jnp.ndarray,
    target_thrust: jnp.ndarray,
    pid_state: PIDRateState,
    dt: float,
    max_thrust_ratio: float = 0.9,
) -> Tuple[jnp.ndarray, jnp.ndarray, PIDRateState]:
    """One PID tick (lee_position_controller.py:476-550).

    Args:
        quat:            (..., 4) wxyz orientation.
        angvel_w:        (..., 3) world-frame angular velocity [rad/s].
        target_rate_deg: (..., 3) body-rate setpoint [deg/s].
        target_thrust:   (..., 1) collective thrust in PWM units [0, 2^16].
        pid_state:       PID carry (already reset where episodes ended).
        dt:              controller period [s].
    Returns:
        (rotor_cmds (...,4) in [-1,1], ctbr (...,4) = [r,p,y,thrust], new state)
    """
    kp = jnp.asarray(PID_KP, dtype=quat.dtype)
    ki = jnp.asarray(PID_KI, dtype=quat.dtype)
    kd = jnp.asarray(PID_KD, dtype=quat.dtype)
    kff = jnp.asarray(PID_KFF, dtype=quat.dtype)
    ilimit = jnp.asarray(I_LIMIT, dtype=quat.dtype)

    body_rate = quat_rotate_inverse(quat, angvel_w) * (180.0 / jnp.pi)
    rate_error = target_rate_deg - body_rate

    out_p = rate_error * kp
    deriv = -(body_rate - pid_state.last_body_rate) / dt
    deriv = jnp.nan_to_num(deriv, nan=0.0)
    out_d = deriv * kd
    integ = jnp.clip(pid_state.integ + rate_error * dt, -ilimit, ilimit)
    out_i = integ * ki
    out_ff = target_rate_deg * kff

    output = out_p + out_d + out_i + out_ff
    output = jnp.nan_to_num(output, nan=0.0)
    output = jnp.clip(output, -OUT_LIMIT, OUT_LIMIT)

    r = output[..., 0:1] / 2.0
    p = output[..., 1:2] / 2.0
    y = output[..., 2:3]

    # PWM mixing (lee_position_controller.py:539-546)
    m1 = target_thrust + r - p + y
    m2 = target_thrust + r + p - y
    m3 = target_thrust - r + p + y
    m4 = target_thrust - r - p - y
    cmds = jnp.concatenate([m1, m2, m3, m4], axis=-1) / (2.0**16) * 2.0 - max_thrust_ratio
    cmds = jnp.nan_to_num(cmds, nan=0.0)

    ctbr = jnp.concatenate([r, p, y, target_thrust], axis=-1)
    new_state = PIDRateState(integ=integ, last_body_rate=body_rate)
    return cmds, ctbr, new_state
