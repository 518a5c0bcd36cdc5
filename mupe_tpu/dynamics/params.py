"""Quadrotor physical parameters and the drone zoo.

The reference keeps per-model constants in YAML files next to USD assets
(reference: omni_drones/robots/assets/usd/*.yaml, loaded by
omni_drones/robots/drone/multirotor.py:67-75).  Here the same physical
constants live as plain data, and `QuadrotorParams` is a JAX pytree so any
leaf can be broadcast/randomized per environment (domain randomization,
reference multirotor.py:406-697) without leaving the compiled step.
"""
from __future__ import annotations

from typing import Any, Dict

import jax.numpy as jnp
import numpy as np

from ..core import struct

# ---------------------------------------------------------------------------
# Drone zoo: physical constants transcribed from the reference asset YAMLs.
# kf_i = max_rot_vel_i^2 * force_constant_i ; km_i likewise (rotor_group.py:42-43).
# ---------------------------------------------------------------------------

DRONE_ZOO: Dict[str, Dict[str, Any]] = {
    # reference: robots/assets/usd/crazyflie.yaml (calibrated sim-to-real params)
    "crazyflie": dict(
        mass=0.0321,
        inertia=(1.4e-5, 1.4e-5, 2.17e-5),
        arm_length=0.043,
        rotor_angles=(0.78539816, 2.35619449, 3.92699082, 5.49778714),
        directions=(-1.0, 1.0, -1.0, 1.0),
        force_constants=2.350347298350041e-08,
        moment_constants=7.24e-10,
        max_rotation_velocities=2315.0,
        time_constant=0.025,
        drag_coef=0.0,
        target_clip=1.0,
        max_thrust_ratio=0.9,
        fixed_yaw=False,
        num_rotors=4,
    ),
    # reference: robots/assets/usd/crazyflie_deploy.yaml (deployment stage)
    "crazyflie_deploy": dict(
        mass=0.0321,
        inertia=(1.4e-5, 1.4e-5, 2.17e-5),
        arm_length=0.043,
        rotor_angles=(0.78539816, 2.35619449, 3.92699082, 5.49778714),
        directions=(-1.0, 1.0, -1.0, 1.0),
        force_constants=2.350347298350041e-08,
        moment_constants=7.24e-10,
        max_rotation_velocities=2315.0,
        time_constant=0.025,
        drag_coef=0.0,
        target_clip=1.0,
        max_thrust_ratio=0.9,
        fixed_yaw=False,
        num_rotors=4,
    ),
    # reference: robots/assets/usd/hummingbird.yaml
    "hummingbird": dict(
        mass=0.716,
        inertia=(0.007, 0.007, 0.012),
        arm_length=0.17,
        rotor_angles=(0.0, 1.57079632679, 3.14159265359, -1.57079632679),
        directions=(-1.0, 1.0, -1.0, 1.0),
        force_constants=8.54858e-06,
        moment_constants=1.3677728816219314e-07,
        max_rotation_velocities=838.0,
        time_constant=0.025,
        drag_coef=0.2,
        target_clip=1.0,
        max_thrust_ratio=1.0,
        fixed_yaw=False,
        num_rotors=4,
    ),
    # reference: robots/assets/usd/firefly.yaml (hexarotor)
    "firefly": dict(
        mass=1.56779,
        inertia=(0.0347563, 0.0458929, 0.0977),
        arm_length=0.215,
        rotor_angles=(
            0.52359877559, 1.57079632679, 2.61799387799,
            -2.61799387799, -1.57079632679, -0.52359877559,
        ),
        directions=(1.0, -1.0, 1.0, -1.0, 1.0, -1.0),
        force_constants=8.54858e-06,
        moment_constants=1.3677728816219314e-07,
        max_rotation_velocities=838.0,
        time_constant=0.025,
        drag_coef=0.3,
        target_clip=1.0,
        max_thrust_ratio=1.0,
        fixed_yaw=False,
        num_rotors=6,
    ),
    # reference: robots/assets/usd/iris.yaml
    "iris": dict(
        mass=1.52,
        inertia=(0.0347563, 0.0458929, 0.0977),
        arm_length=0.255539,
        rotor_angles=(-0.533708, 2.565218, 0.533708, -2.565218),
        directions=(1.0, 1.0, -1.0, -1.0),
        force_constants=8.54858e-06,
        moment_constants=1.3677728816219314e-07,
        max_rotation_velocities=838.0,
        time_constant=0.025,
        drag_coef=0.2,
        target_clip=1.0,
        max_thrust_ratio=1.0,
        fixed_yaw=False,
        num_rotors=4,
    ),
    # reference: robots/assets/usd/neo11.yaml (hexarotor)
    "neo11": dict(
        mass=3.42,
        inertia=(0.0608, 0.0688, 0.1489),
        arm_length=0.2895,
        rotor_angles=(
            0.52359877559, 1.57079632679, 2.61799387799,
            -2.61799387799, -1.57079632679, -0.52359877559,
        ),
        directions=(1.0, -1.0, 1.0, -1.0, 1.0, -1.0),
        force_constants=1.269e-05,
        moment_constants=2.12608256333624e-07,
        max_rotation_velocities=1047.2,
        time_constant=0.025,
        drag_coef=0.3,
        target_clip=1.0,
        max_thrust_ratio=1.0,
        fixed_yaw=False,
        num_rotors=6,
    ),
    # reference: robots/assets/usd/omav.yaml (12-rotor omnidirectional; modeled
    # here as a planar 12-rotor ring — tilt actuation is out of scope, as the
    # reference never trains it)
    "omav": dict(
        mass=4.04,
        inertia=(0.3, 0.3, 0.5),
        arm_length=0.3,
        rotor_angles=tuple(np.linspace(0.0, 2.0 * np.pi, 12, endpoint=False).tolist()),
        directions=(1.0, -1.0, -1.0, 1.0, 1.0, -1.0, -1.0, 1.0, -1.0, 1.0, 1.0, -1.0),
        force_constants=7.2e-06,
        moment_constants=1.0799999999999999e-07,
        max_rotation_velocities=1700.0,
        time_constant=0.025,
        drag_coef=0.3,
        target_clip=1.0,
        max_thrust_ratio=1.0,
        fixed_yaw=False,
        num_rotors=12,
    ),
}


@struct.dataclass
class QuadrotorParams:
    """Per-drone physical parameters as a JAX pytree.

    Every array leaf may carry leading batch dimensions broadcastable against
    the drone state (e.g. ``(num_envs, 1, num_rotors)``), which is how domain
    randomization produces per-env dynamics without recompilation.
    """

    mass: jnp.ndarray            # ()           kg
    inertia: jnp.ndarray         # (3,)         diagonal kg m^2
    kf: jnp.ndarray              # (R,)         max thrust per rotor [N]
    km: jnp.ndarray              # (R,)         max yaw moment per rotor [N m]
    directions: jnp.ndarray      # (R,)         +1 ccw / -1 cw
    tau_up: jnp.ndarray          # (R,)         rotor spin-up time constant
    tau_down: jnp.ndarray        # (R,)         rotor spin-down time constant
    rotor_pos: jnp.ndarray       # (R, 3)       rotor offsets in body frame [m]
    drag_coef: jnp.ndarray       # ()           body drag coefficient
    # CTBR interface constants (crazyflie.yaml:4-5)
    target_clip: float = struct.field(pytree_node=False, default=1.0)
    max_thrust_ratio: float = struct.field(pytree_node=False, default=1.0)
    fixed_yaw: bool = struct.field(pytree_node=False, default=False)
    num_rotors: int = struct.field(pytree_node=False, default=4)

    @property
    def gravity(self) -> jnp.ndarray:
        return self.mass * 9.81

    @property
    def max_thrust(self) -> jnp.ndarray:
        """Total thrust at full throttle (= Σ kf)."""
        return jnp.sum(self.kf, axis=-1)

    @property
    def hover_throttle(self) -> jnp.ndarray:
        """Steady-state throttle that exactly cancels gravity.

        f_inv(mg / Σ KF) — matches multirotor.py:647-648 (`_reset_idx`).
        """
        return jnp.sqrt(self.gravity / jnp.sum(self.kf, axis=-1))


def make_params(model: str = "crazyflie", dtype=jnp.float32) -> QuadrotorParams:
    """Build `QuadrotorParams` for a drone-zoo model."""
    cfg = DRONE_ZOO[model]
    r = cfg["num_rotors"]
    angles = np.asarray(cfg["rotor_angles"], dtype=np.float64)
    arm = float(cfg["arm_length"])
    rotor_pos = np.stack(
        [arm * np.cos(angles), arm * np.sin(angles), np.zeros_like(angles)], axis=-1
    )
    omega_max = np.full((r,), cfg["max_rotation_velocities"], dtype=np.float64)
    kf = omega_max**2 * np.full((r,), cfg["force_constants"], dtype=np.float64)
    km = omega_max**2 * np.full((r,), cfg["moment_constants"], dtype=np.float64)
    return QuadrotorParams(
        mass=jnp.asarray(cfg["mass"], dtype),
        inertia=jnp.asarray(cfg["inertia"], dtype),
        kf=jnp.asarray(kf, dtype),
        km=jnp.asarray(km, dtype),
        directions=jnp.asarray(cfg["directions"], dtype),
        tau_up=jnp.full((r,), cfg["time_constant"], dtype),
        tau_down=jnp.full((r,), cfg["time_constant"], dtype),
        rotor_pos=jnp.asarray(rotor_pos, dtype),
        drag_coef=jnp.asarray(cfg["drag_coef"], dtype),
        target_clip=float(cfg["target_clip"]),
        max_thrust_ratio=float(cfg["max_thrust_ratio"]),
        fixed_yaw=bool(cfg["fixed_yaw"]),
        num_rotors=r,
    )


@struct.dataclass
class RigidBodyCfg:
    """PhysX-style rigid-body integration properties.

    Defaults match the reference articulation properties
    (omni_drones/robots/config.py:28-45): damping 0.2, velocity caps 1000.
    `max_linear_velocity` is overridden per task (hideandseek.py:539 sets it
    to v_drone).
    """

    linear_damping: float = struct.field(pytree_node=False, default=0.2)
    angular_damping: float = struct.field(pytree_node=False, default=0.2)
    max_linear_velocity: float = struct.field(pytree_node=False, default=1000.0)
    max_angular_velocity: float = struct.field(pytree_node=False, default=1000.0)
    ground_collision: bool = struct.field(pytree_node=False, default=True)
