"""Pure-JAX quadrotor rigid-body dynamics.

This module replaces the reference's Isaac Sim / PhysX backend (L0) *and* its
robot layer (reference: omni_drones/robots/drone/multirotor.py,
omni_drones/actuators/rotor_group.py) with a single statically-shaped,
``vmap``-friendly step function:

    rotor cmds ∈ [-1, 1]^R
      → first-order rotor lag                (rotor_group.py:55-71)
      → per-rotor thrust + yaw moment        (rotor_group.py:66-69)
      → body wrench (incl. arm torques)      (multirotor.py:466-508)
      → downwash + linear drag               (multirotor.py:488-495, 724-753)
      → semi-implicit Euler integration      (PhysX step, dt = 0.01)

All functions broadcast over arbitrary leading batch dimensions, typically
``[num_envs, n_agents]``.  There is no "views" layer: state is an explicit
pytree, and the environment owns it.
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from ..core import struct
from ..core import quat_axis, quat_integrate, quat_rotate, quat_rotate_inverse
from .params import QuadrotorParams, RigidBodyCfg


@struct.dataclass
class DroneState:
    """Kinematic + actuator state of a (batch of) quadrotor(s).

    Leading dims are arbitrary; the canonical layout is [num_envs, n_agents].
    Replaces the physics-tensor views of reference views/articulation_view.py.
    """

    pos: jnp.ndarray       # (..., 3)  world position (env-local frame)
    quat: jnp.ndarray      # (..., 4)  wxyz body→world rotation
    vel: jnp.ndarray       # (..., 3)  world linear velocity
    angvel: jnp.ndarray    # (..., 3)  world angular velocity
    throttle: jnp.ndarray  # (..., R)  normalized rotor throttle in [0, 1]

    @property
    def heading(self) -> jnp.ndarray:
        """World-frame body x-axis (multirotor.py:614)."""
        return quat_axis(self.quat, 0)

    @property
    def up(self) -> jnp.ndarray:
        """World-frame body z-axis (multirotor.py:615)."""
        return quat_axis(self.quat, 2)

    @property
    def vel6(self) -> jnp.ndarray:
        return jnp.concatenate([self.vel, self.angvel], axis=-1)

    @property
    def body_rate(self) -> jnp.ndarray:
        """Angular velocity in the body frame [rad/s]."""
        return quat_rotate_inverse(self.quat, self.angvel)

    def state_vector(self) -> jnp.ndarray:
        """The 19+R-dim observation state of multirotor.py:599-633:
        [pos(3), quat(4), vel_w(3), angvel_w(3), heading(3), up(3), 2·throttle−1(R)].
        """
        return jnp.concatenate(
            [
                self.pos,
                self.quat,
                self.vel,
                self.angvel,
                self.heading,
                self.up,
                self.throttle * 2.0 - 1.0,
            ],
            axis=-1,
        )


def hover_state(
    params: QuadrotorParams, pos: jnp.ndarray, quat: jnp.ndarray
) -> DroneState:
    """A zero-velocity state with hover throttle (reference _reset_idx,
    multirotor.py:635-650)."""
    batch = pos.shape[:-1]
    throttle = jnp.broadcast_to(
        params.hover_throttle[..., None], batch + (params.num_rotors,)
    )
    return DroneState(
        pos=pos,
        quat=quat,
        vel=jnp.zeros(batch + (3,), pos.dtype),
        angvel=jnp.zeros(batch + (3,), pos.dtype),
        throttle=throttle.astype(pos.dtype),
    )


def rotor_response(
    params: QuadrotorParams,
    throttle: jnp.ndarray,
    cmds: jnp.ndarray,
    dt: float,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """First-order rotor lag and thrust/moment curves.

    Matches rotor_group.py:55-71 exactly:
        target   = sqrt(clip((cmd+1)/2, 0, 1))
        throttle += (dt / τ) (target − throttle),  τ = τ_up if spinning up
        thrust_i = throttle² · KF_i
        moment_i = −dir_i · throttle² · KM_i
    Returns (new_throttle, thrusts, moments), each (..., R).
    """
    target = jnp.sqrt(jnp.clip((cmds + 1.0) * 0.5, 0.0, 1.0))
    tau = jnp.where(target > throttle, params.tau_up, params.tau_down)
    tau = jnp.clip(tau, 0.0, 1.0)
    alpha = dt / tau
    new_throttle = throttle + alpha * (target - throttle)
    t = jnp.clip(jnp.square(new_throttle), 0.0, 1.0)
    thrusts = t * params.kf
    moments = t * params.km * (-params.directions)
    return new_throttle, thrusts, moments


def body_wrench(
    params: QuadrotorParams, thrusts: jnp.ndarray, moments: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Aggregate per-rotor thrusts into a body-frame force and torque.

    The reference applies each thrust at its rotor offset with PhysX
    (multirotor.py:497-506); the equivalent analytic wrench is
        F_b = Σ f_i ẑ,     τ_b = Σ r_i × (f_i ẑ) + Σ m_i ẑ.
    """
    force_z = jnp.sum(thrusts, axis=-1)
    force_b = jnp.stack(
        [jnp.zeros_like(force_z), jnp.zeros_like(force_z), force_z], axis=-1
    )
    # r × (f ẑ) = f · (r_y, −r_x, 0)
    rx = params.rotor_pos[..., 0]
    ry = params.rotor_pos[..., 1]
    tau_x = jnp.sum(thrusts * ry, axis=-1)
    tau_y = jnp.sum(-thrusts * rx, axis=-1)
    tau_z = jnp.sum(moments, axis=-1)
    torque_b = jnp.stack([tau_x, tau_y, tau_z], axis=-1)
    return force_b, torque_b


def downwash_forces(
    pos: jnp.ndarray,
    thrust_w: jnp.ndarray,
    kr: float = 2.0,
    kz: float = 0.3,
) -> jnp.ndarray:
    """Pairwise downwash among the drones of one arena.

    Matches multirotor.py:724-753 (`downwash` + `separation`): drone *i*
    receives from every *other* drone *j* a force
        −T_j · exp(−0.5 (kr·r/z)²) / (1 + kz·z)²
    where z/r are the axial/radial separations along j's thrust direction.

    Args:
        pos:      (..., n, 3) drone positions.
        thrust_w: (..., n, 3) world-frame total thrust vectors R_j·F_j.
    Returns:
        (..., n, 3) forces.
    """
    d = thrust_w / (jnp.linalg.norm(thrust_w, axis=-1, keepdims=True) + 1e-6)
    # rel[..., i, j, :] = p_j − p_i  (multirotor.py:747: p1[None] − p0[:, None])
    rel = pos[..., None, :, :] - pos[..., :, None, :]
    dj = jnp.broadcast_to(d[..., None, :, :], rel.shape)
    z = jnp.sum(rel * dj, axis=-1, keepdims=True)
    r_vec = rel - z * dj
    r = jnp.linalg.norm(r_vec, axis=-1, keepdims=True)
    z = jnp.clip(z, 0.0, None)
    v = jnp.exp(-0.5 * jnp.square(kr * r / jnp.where(z == 0.0, 1e-6, z))) / jnp.square(
        1.0 + kz * z
    )
    f = v * (-jnp.broadcast_to(thrust_w[..., None, :, :], rel.shape))
    # zero out the diagonal (i == j), then sum over j — off_diag + sum in the ref
    n = pos.shape[-2]
    eye = jnp.eye(n, dtype=bool)[..., None]
    f = jnp.where(eye, 0.0, f)
    return jnp.sum(f, axis=-2)


def integrate(
    params: QuadrotorParams,
    state: DroneState,
    force_w: jnp.ndarray,
    torque_b: jnp.ndarray,
    dt: float,
    cfg: RigidBodyCfg = RigidBodyCfg(),
    new_throttle: jnp.ndarray | None = None,
) -> DroneState:
    """Semi-implicit Euler step of the rigid body (the PhysX step equivalent).

    Velocity is updated first, damped PhysX-style (v *= max(0, 1 − c·dt)),
    clamped to the configured maxima, then positions/orientation integrate
    with the *new* velocity.  Gravity is added here.
    """
    inv_mass = 1.0 / params.mass
    accel = force_w * inv_mass[..., None] + jnp.asarray(
        [0.0, 0.0, -9.81], dtype=force_w.dtype
    )
    vel = state.vel + dt * accel
    vel = vel * max(0.0, 1.0 - cfg.linear_damping * dt)
    speed = jnp.linalg.norm(vel, axis=-1, keepdims=True)
    vel = vel * jnp.minimum(1.0, cfg.max_linear_velocity / (speed + 1e-9))

    # angular dynamics in the body frame: I ω̇ = τ − ω × (I ω)
    omega_b = state.body_rate
    i_omega = params.inertia * omega_b
    ang_acc_b = (torque_b - jnp.cross(omega_b, i_omega)) / params.inertia
    omega_b = omega_b + dt * ang_acc_b
    omega_b = omega_b * max(0.0, 1.0 - cfg.angular_damping * dt)
    rate = jnp.linalg.norm(omega_b, axis=-1, keepdims=True)
    omega_b = omega_b * jnp.minimum(1.0, cfg.max_angular_velocity / (rate + 1e-9))
    angvel = quat_rotate(state.quat, omega_b)

    pos = state.pos + dt * vel
    quat = quat_integrate(state.quat, angvel, dt)

    if cfg.ground_collision:
        below = pos[..., 2:3] < 0.0
        pos = pos.at[..., 2].set(jnp.maximum(pos[..., 2], 0.0))
        vel = jnp.where(
            below, vel.at[..., 2].set(jnp.maximum(vel[..., 2], 0.0)), vel
        )

    return state.replace(
        pos=pos,
        quat=quat,
        vel=vel,
        angvel=angvel,
        throttle=state.throttle if new_throttle is None else new_throttle,
    )


def step(
    params: QuadrotorParams,
    state: DroneState,
    rotor_cmds: jnp.ndarray,
    dt: float,
    cfg: RigidBodyCfg = RigidBodyCfg(),
    enable_downwash: bool = True,
    ext_force_w: jnp.ndarray | None = None,
) -> Tuple[DroneState, jnp.ndarray]:
    """One full quadrotor sim tick (multirotor.py:466-508 + PhysX step).

    `state` has layout (..., n, ·); downwash couples the n drones of each
    arena when n > 1.  Returns (new_state, throttle_difference) where
    `throttle_difference` = ‖throttle_t − throttle_{t−1}‖ (multirotor.py:507),
    used by smoothness stats.
    """
    new_throttle, thrusts, moments = rotor_response(
        params, state.throttle, rotor_cmds, dt
    )
    force_b, torque_b = body_wrench(params, thrusts, moments)
    force_w = quat_rotate(state.quat, force_b)

    if enable_downwash and state.pos.shape[-2] > 1:
        force_w = force_w + downwash_forces(state.pos, force_w)
    # linear "drag" force (multirotor.py:495) — sign matches the reference
    force_w = force_w + (params.drag_coef * params.mass)[..., None] * state.vel
    if ext_force_w is not None:
        # external world-frame force at the COM (assembly constraint
        # forces — e.g. the transport group's rods)
        force_w = force_w + ext_force_w

    new_state = integrate(
        params, state, force_w, torque_b, dt, cfg, new_throttle=new_throttle
    )
    throttle_diff = jnp.linalg.norm(new_throttle - state.throttle, axis=-1)
    return new_state, throttle_diff
