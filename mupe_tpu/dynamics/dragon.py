"""Dragon: articulated multi-link drone, JAX compliant-joint model.

Counterpart of the reference's `Dragon(MultirotorBase)`
(omni_drones/robots/drone/dragon.py:45-244): a chain of `num_links` rigid
link modules, each carrying a 2-rotor gimbal module, consecutive links
connected by D6 joints limited to ±90° about local y/z with position
drives (stiffness 1, damping 0.5; dragon.py:221-238), gimbal joints
velocity-driven (apply_action, dragon.py:155-188), and a flat state vector
[pos, rot, vel6, heading, up | 2·throttle−1 | gimbal/π | link-joint/π]
per link (get_state, dragon.py:191-214).

JAX re-design: the reference leans on PhysX's articulation solver;
here every link is an independent 6-DoF rigid body in MAXIMAL coordinates
([E, L]-batched, same semi-implicit Euler as `quadrotor.step`), and the
D6 joints become compliant constraints — a stiff point-to-point
spring+damper at the anchor (±0.15 m on the link x-axis,
dragon.py:225-226) plus rotational springs: the unlimited relative-roll
axis is locked by a stiff spring, and the y/z axes track the commanded
joint targets with the reference's drive gains.  This is the standard
spring-joint formulation of articulated dynamics used by differentiable
simulators (e.g. Brax's spring pipeline): fully vectorized, no iterative
constraint solve, jit/vmap/scan-friendly, and stable at dt = 0.01 with
the gains below (ω ≈ √(kp/m) ≈ 32 rad/s ⇒ dt·ω ≈ 0.32).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import struct
from ..core import (
    quat_axis,
    quat_conjugate,
    quat_integrate,
    quat_mul,
    quat_rotate,
)


@dataclasses.dataclass(frozen=True)
class DragonCfg:
    """Geometry/actuation constants (reference DragonCfg, dragon.py:62-81:
    4 links 0.3 m apart, 2 rotors per link with kf 7.2e-6, km 1.08e-7,
    ω_max 800; joint drive stiffness 1, damping 0.5)."""

    num_links: int = 4
    link_mass: float = 0.4            # kg per module (USD asset scale)
    # rod-like module spanning ~0.3 m: I ≈ m·l²/12 ≈ 3e-3 kg·m²
    link_inertia: Tuple[float, float, float] = (3.0e-3, 3.0e-3, 5.0e-3)
    link_spacing: float = 0.3         # m between link origins (dragon.py:219)
    joint_anchor: float = 0.15        # m anchor offset on ±x (dragon.py:225)
    rotor_arm: float = 0.08           # rotor pair offset on ±y
    force_constant: float = 7.2e-6
    moment_constant: float = 1.08e-7
    max_rotation_velocity: float = 800.0
    rotor_tau: float = 0.12           # first-order rotor lag
    # compliant joint gains: point-to-point spring and the locked-roll spring
    joint_kp: float = 400.0
    joint_kd: float = 12.0            # ζ ≈ 0.7 against m_eff = m/2
    rot_lock_kp: float = 2.0
    rot_lock_kd: float = 0.1
    # D6 position-drive gains on the y/z joint axes (dragon.py:233-236)
    drive_stiffness: float = 1.0
    drive_damping: float = 0.5
    gimbal_rate: float = np.pi / 2.0  # rad/s at |cmd| = 1 (dragon.py:178)
    linear_damping: float = 0.05
    angular_damping: float = 0.01
    # inner substeps per control step.  The binding constraint is the
    # D6 drive's RELATIVE damping (0.5 N·m·s/rad on I = 3e-3): explicitly
    # integrated, its rate is d/I ≈ 167/s, doubled for the relative mode
    # and doubled again on interior links with two joints — stability
    # needs dt_sub · rate < 2, i.e. dt_sub ≤ 2.5 ms (verified: a 1e-4
    # angular perturbation decays 100× over 1 s at substeps=4).
    substeps: int = 4

    @property
    def num_rotors(self) -> int:
        return 2 * self.num_links

    @property
    def action_split(self) -> Tuple[int, int, int]:
        """(rotor cmds, gimbal velocity targets, link-joint position
        targets) — dragon.py:92."""
        return (
            self.num_rotors,
            2 * self.num_links,
            2 * (self.num_links - 1),
        )

    @property
    def action_dim(self) -> int:
        return sum(self.action_split)

    @property
    def state_dim(self) -> int:
        # per link: pos3 + quat4 + vel6 + heading3 + up3 + throttle2 +
        # gimbal2; plus 2 joint angles per link joint (dragon.py:96-101)
        return self.num_links * 23 + (self.num_links - 1) * 2

    @property
    def kf(self) -> float:
        return self.force_constant * self.max_rotation_velocity**2

    @property
    def km(self) -> float:
        return self.moment_constant * self.max_rotation_velocity**2


@struct.dataclass
class DragonLinkState:
    """[E, L]-batched maximal-coordinate state of the link chain."""

    pos: jnp.ndarray       # [E, L, 3] world
    quat: jnp.ndarray      # [E, L, 4] wxyz body→world
    vel: jnp.ndarray       # [E, L, 3] world linear velocity
    angvel: jnp.ndarray    # [E, L, 3] world angular velocity
    throttle: jnp.ndarray  # [E, 2L]
    gimbal: jnp.ndarray    # [E, L, 2] gimbal joint angles (rad)


def dragon_init(cfg: DragonCfg, pos0: jnp.ndarray) -> DragonLinkState:
    """Spawn the chain extended along +x from `pos0` [E, 3] at hover
    throttle (gravity-balancing steady state)."""
    e = pos0.shape[0]
    offs = jnp.arange(cfg.num_links)[:, None] * jnp.asarray(
        [cfg.link_spacing, 0.0, 0.0]
    )
    pos = pos0[:, None, :] + offs[None]
    quat = jnp.zeros((e, cfg.num_links, 4)).at[..., 0].set(1.0)
    hover = jnp.sqrt(cfg.link_mass * 9.81 / (2.0 * cfg.kf))
    return DragonLinkState(
        pos=pos,
        quat=quat,
        vel=jnp.zeros((e, cfg.num_links, 3)),
        angvel=jnp.zeros((e, cfg.num_links, 3)),
        throttle=jnp.full((e, cfg.num_rotors), hover),
        gimbal=jnp.zeros((e, cfg.num_links, 2)),
    )


def _gimbal_axis(gimbal: jnp.ndarray) -> jnp.ndarray:
    """Rotor thrust axis in the link frame from the 2-DoF gimbal module:
    tilt about link y (g0) then x (g1) applied to ẑ."""
    gy, gx = gimbal[..., 0], gimbal[..., 1]
    return jnp.stack(
        [
            jnp.sin(gy) * jnp.cos(gx),
            -jnp.sin(gx),
            jnp.cos(gy) * jnp.cos(gx),
        ],
        axis=-1,
    )


def _small_angles(q_rel: jnp.ndarray) -> jnp.ndarray:
    """Relative rotation → per-axis angles (2·vector part, sign-corrected):
    exact for small angles, monotone to ±π — all the compliance needs."""
    s = jnp.sign(q_rel[..., :1])
    s = jnp.where(s == 0.0, 1.0, s)
    return 2.0 * q_rel[..., 1:] * s


def dragon_step(
    cfg: DragonCfg,
    state: DragonLinkState,
    action: jnp.ndarray,      # [E, action_dim] in [-1, 1]
    dt: float,
) -> DragonLinkState:
    """One control step = `cfg.substeps` inner physics steps: rotor lag →
    per-link wrench → compliant joint forces/drives → semi-implicit Euler
    (mirrors quadrotor.integrate)."""
    sub_dt = dt / cfg.substeps
    for _ in range(cfg.substeps):
        state = _dragon_substep(cfg, state, action, sub_dt)
    return state


def _dragon_substep(
    cfg: DragonCfg,
    state: DragonLinkState,
    action: jnp.ndarray,
    dt: float,
) -> DragonLinkState:
    e = action.shape[0]
    L = cfg.num_links
    n_rot, n_gim, n_link = cfg.action_split
    rotor_cmds = action[:, :n_rot]
    gimbal_cmds = action[:, n_rot : n_rot + n_gim].reshape(e, L, 2)
    link_cmds = action[:, n_rot + n_gim :].reshape(e, L - 1, 2)

    # ---- rotors: first-order lag, thrust/moment curves (RotorGroup match)
    target = jnp.sqrt(jnp.clip((rotor_cmds + 1.0) * 0.5, 0.0, 1.0))
    throttle = state.throttle + (dt / cfg.rotor_tau) * (target - state.throttle)
    t2 = jnp.square(throttle).reshape(e, L, 2)
    dirs = jnp.asarray([1.0, -1.0])
    thrust = t2 * cfg.kf                             # [E, L, 2]
    moment = -dirs * t2 * cfg.km                     # [E, L, 2] about axis

    # ---- gimbal joints: velocity targets integrate to angles (±π/2)
    gimbal = jnp.clip(
        state.gimbal + dt * jnp.clip(gimbal_cmds, -1.0, 1.0) * cfg.gimbal_rate,
        -np.pi / 2, np.pi / 2,
    )
    axis_b = _gimbal_axis(gimbal)                    # [E, L, 3] link frame
    axis_w = quat_rotate(state.quat, axis_b)

    # per-link rotor wrench: both rotors share the gimbal axis, mounted at
    # ±rotor_arm on the link y-axis
    f_rot = jnp.sum(thrust[..., None] * axis_w[..., None, :], axis=-2)
    arm = jnp.asarray([0.0, cfg.rotor_arm, 0.0])
    r_plus = quat_rotate(state.quat, jnp.broadcast_to(arm, axis_w.shape))
    tau_rot = (
        jnp.cross(r_plus, thrust[..., 0:1] * axis_w)
        + jnp.cross(-r_plus, thrust[..., 1:2] * axis_w)
        + jnp.sum(moment[..., None] * axis_w[..., None, :], axis=-2)
    )

    # ---- compliant D6 joints between consecutive links
    a_par = state.pos[:, :-1] + quat_rotate(
        state.quat[:, :-1],
        jnp.broadcast_to(
            jnp.asarray([cfg.joint_anchor, 0.0, 0.0]), (e, L - 1, 3)
        ),
    )
    a_chd = state.pos[:, 1:] + quat_rotate(
        state.quat[:, 1:],
        jnp.broadcast_to(
            jnp.asarray([-cfg.joint_anchor, 0.0, 0.0]), (e, L - 1, 3)
        ),
    )
    r_par = a_par - state.pos[:, :-1]
    r_chd = a_chd - state.pos[:, 1:]
    v_par = state.vel[:, :-1] + jnp.cross(state.angvel[:, :-1], r_par)
    v_chd = state.vel[:, 1:] + jnp.cross(state.angvel[:, 1:], r_chd)
    f_joint = cfg.joint_kp * (a_chd - a_par) + cfg.joint_kd * (v_chd - v_par)

    # rotational: relative orientation in the parent frame
    q_rel = quat_mul(quat_conjugate(state.quat[:, :-1]), state.quat[:, 1:])
    ang = _small_angles(q_rel)                       # [E, L-1, 3] (x, y, z)
    rel_w = state.angvel[:, 1:] - state.angvel[:, :-1]
    rel_b = quat_rotate(quat_conjugate(state.quat[:, :-1]), rel_w)
    targets = jnp.clip(link_cmds, -1.0, 1.0) * (np.pi / 2)  # y/z drives
    tau_b = jnp.stack(
        [
            -cfg.rot_lock_kp * ang[..., 0] - cfg.rot_lock_kd * rel_b[..., 0],
            cfg.drive_stiffness * (targets[..., 0] - ang[..., 1])
            - cfg.drive_damping * rel_b[..., 1],
            cfg.drive_stiffness * (targets[..., 1] - ang[..., 2])
            - cfg.drive_damping * rel_b[..., 2],
        ],
        axis=-1,
    )
    tau_joint = quat_rotate(state.quat[:, :-1], tau_b)   # world frame

    # scatter joint wrenches to the chain ends (static pad, no gathers)
    zero = jnp.zeros((e, 1, 3))
    f_net = (
        f_rot
        + jnp.concatenate([f_joint, zero], axis=1)       # on parents
        - jnp.concatenate([zero, f_joint], axis=1)       # reaction on children
    )
    f_net = f_net + jnp.asarray([0.0, 0.0, -cfg.link_mass * 9.81])
    f_net = f_net - cfg.linear_damping * state.vel
    tau_net = (
        tau_rot
        + jnp.concatenate(
            [jnp.cross(r_par, f_joint) - tau_joint, zero], axis=1
        )
        + jnp.concatenate(
            [zero, jnp.cross(r_chd, -f_joint) + tau_joint], axis=1
        )
        - cfg.angular_damping * state.angvel
    )

    # ---- semi-implicit Euler (same scheme as quadrotor.integrate)
    inertia = jnp.asarray(cfg.link_inertia)
    vel = state.vel + dt * f_net / cfg.link_mass
    pos = state.pos + dt * vel
    # world-frame rotational dynamics with diagonal body inertia: treat the
    # gyroscopic term in the body frame
    w_b = quat_rotate(quat_conjugate(state.quat), state.angvel)
    tau_b_net = quat_rotate(quat_conjugate(state.quat), tau_net)
    dw_b = (tau_b_net - jnp.cross(w_b, inertia * w_b)) / inertia
    w_b = w_b + dt * dw_b
    angvel = quat_rotate(state.quat, w_b)
    quat = quat_integrate(state.quat, angvel, dt)
    return DragonLinkState(
        pos=pos,
        quat=quat,
        vel=vel,
        angvel=angvel,
        throttle=throttle,
        gimbal=gimbal,
    )


def dragon_state_vector(cfg: DragonCfg, state: DragonLinkState) -> jnp.ndarray:
    """Flat observation [E, state_dim] matching the reference layout
    (get_state, dragon.py:191-214): per-link [pos, rot, vel6, heading, up]
    flattened, then 2·throttle−1, gimbal/π, link-joint angles/π."""
    e = state.pos.shape[0]
    heading = quat_axis(state.quat, 0)
    up = quat_axis(state.quat, 2)
    per_link = jnp.concatenate(
        [state.pos, state.quat, state.vel, state.angvel, heading, up], axis=-1
    ).reshape(e, -1)
    q_rel = quat_mul(quat_conjugate(state.quat[:, :-1]), state.quat[:, 1:])
    joint_ang = _small_angles(q_rel)[..., 1:3].reshape(e, -1) / np.pi
    return jnp.concatenate(
        [
            per_link,
            state.throttle * 2.0 - 1.0,
            state.gimbal.reshape(e, -1) / np.pi,
            joint_ang,
        ],
        axis=-1,
    )
