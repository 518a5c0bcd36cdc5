"""TransportationGroup — N drones carrying a slung payload via rigid bars.

JAX counterpart of the reference assembly
(omni_drones/robots/assembly/transportation_group.py:19-145 +
examples/demo_transport.py): four drones at (±0.5, ±0.5, 0) in the group
frame, a 2 kg box payload hanging 1.1 m below the group origin, each drone
connected to its payload anchor by a 1 m bar.

The reference builds this as a PhysX articulation (USD joints, bars as
rigid links).  Here the assembly uses the same compliant-joint
maximal-coordinate formulation as the Dragon model (`dynamics/dragon.py`):
every body is a free rigid body and each bar is a stiff rod — a
spring-damper along the drone↔anchor line (ball joints at both ends make a
physical bar exactly a distance constraint).  Fully vectorized over
arenas, no iterative solver, `lax`-free straight-line math; the drone
bodies reuse the production quadrotor step (rotor lag, drag, downwash)
with the rod force injected as an external COM force.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp

from ..core import struct
from ..core.quat import quat_mul, quat_rotate
from .params import DRONE_ZOO, QuadrotorParams, make_params
from .quadrotor import DroneState, RigidBodyCfg, hover_state
from .quadrotor import step as drone_step


@dataclasses.dataclass(frozen=True)
class TransportCfg:
    """Assembly constants (transportation_group.py:63-112)."""

    drone_model: str = "firefly"
    n_drones: int = 4
    payload_mass: float = 2.0
    # Isaac Cube scale (0.5, 0.5, 0.2) → half extents (transportation_group.py:66-68)
    payload_half_extents: Tuple[float, float, float] = (0.25, 0.25, 0.1)
    payload_offset_z: float = -1.1     # group frame (ibid.:65)
    bar_length: float = 1.0            # ibid.:105-112
    bar_mass: float = 0.03             # lumped half/half onto each endpoint
    linear_damping: float = 0.1        # payload rigid-body props (ibid.:74-78)
    angular_damping: float = 0.1
    # compliant rod gains (Dragon-style; rod sag ≈ 2 mm under the static
    # per-rod share of the payload weight)
    rod_stiffness: float = 400.0
    rod_damping: float = 20.0
    # tangential relative-velocity damping: the reference's bars are rigid
    # LINKS in a PhysX articulation (transportation_group.py:105-112), not
    # ball-jointed cables — they resist lateral motion too.  This term
    # damps the slung-load pendulum mode the way the stiff linkage does.
    rod_tangential_damping: float = 1.5
    substeps: int = 4

    @property
    def drone_offsets(self) -> jnp.ndarray:
        """Drone spawn points in the group frame (ibid.:81-88)."""
        return jnp.asarray(
            [[0.5, 0.5, 0.0], [0.5, -0.5, 0.0],
             [-0.5, -0.5, 0.0], [-0.5, 0.5, 0.0]][: self.n_drones]
        )

    @property
    def anchor_body(self) -> jnp.ndarray:
        """Rod anchors in the PAYLOAD body frame: directly under each
        drone, on the payload's top plane."""
        off = self.drone_offsets
        top = jnp.full((off.shape[0], 1), self.payload_half_extents[2])
        return jnp.concatenate([off[:, :2], top], axis=-1)

    @property
    def payload_inertia(self) -> jnp.ndarray:
        hx, hy, hz = self.payload_half_extents
        m = self.payload_mass
        return jnp.asarray(
            [m / 3.0 * (hy * hy + hz * hz),
             m / 3.0 * (hx * hx + hz * hz),
             m / 3.0 * (hx * hx + hy * hy)]
        )


@struct.dataclass
class TransportState:
    """Assembly state: drone bodies [E, n, ·] + payload rigid body [E, ·]."""

    drones: DroneState
    payload_pos: jnp.ndarray     # [E, 3]
    payload_quat: jnp.ndarray    # [E, 4] wxyz
    payload_vel: jnp.ndarray     # [E, 3]
    payload_omega: jnp.ndarray   # [E, 3] body-frame angular velocity


def transport_init(
    cfg: TransportCfg, params: QuadrotorParams, origin: jnp.ndarray
) -> TransportState:
    """Spawn the assembly at group origin(s) [E, 3]
    (transportation_group.py:37-120 spawn translations)."""
    e = origin.shape[0]
    drone_pos = origin[:, None, :] + cfg.drone_offsets[None]
    quat = jnp.broadcast_to(
        jnp.asarray([1.0, 0.0, 0.0, 0.0]), (e, cfg.n_drones, 4)
    )
    drones = hover_state(params, drone_pos, quat)
    payload_pos = origin + jnp.asarray([0.0, 0.0, cfg.payload_offset_z])
    return TransportState(
        drones=drones,
        payload_pos=payload_pos,
        payload_quat=jnp.broadcast_to(
            jnp.asarray([1.0, 0.0, 0.0, 0.0]), (e, 4)
        ),
        payload_vel=jnp.zeros((e, 3)),
        payload_omega=jnp.zeros((e, 3)),
    )


def _rod_forces(cfg: TransportCfg, state: TransportState):
    """Per-drone rod force (world frame) and the payload reaction wrench."""
    anchors_b = cfg.anchor_body[None]                         # [1, n, 3]
    q = state.payload_quat[:, None, :]
    r_w = quat_rotate(q, anchors_b)                           # [E, n, 3]
    anchors_w = state.payload_pos[:, None, :] + r_w
    omega_w = quat_rotate(state.payload_quat, state.payload_omega)
    anchor_vel = (
        state.payload_vel[:, None, :]
        + jnp.cross(omega_w[:, None, :], r_w)
    )
    d = state.drones.pos - anchors_w                          # [E, n, 3]
    dist = jnp.linalg.norm(d, axis=-1, keepdims=True)
    u = d / (dist + 1e-9)
    rel_v = state.drones.vel - anchor_vel
    v_rad = jnp.sum(rel_v * u, axis=-1, keepdims=True)
    tension = cfg.rod_stiffness * (dist - cfg.bar_length) + cfg.rod_damping * v_rad
    v_tan = rel_v - v_rad * u
    f_drone = -tension * u - cfg.rod_tangential_damping * v_tan  # [E, n, 3]
    f_payload_w = -jnp.sum(f_drone, axis=1)                   # [E, 3]
    tau_payload_w = -jnp.sum(jnp.cross(r_w, f_drone), axis=1)
    return f_drone, f_payload_w, tau_payload_w


def transport_step(
    cfg: TransportCfg,
    params: QuadrotorParams,
    state: TransportState,
    rotor_cmds: jnp.ndarray,
    dt: float,
    body_cfg: RigidBodyCfg = RigidBodyCfg(),
) -> TransportState:
    """One assembly tick: rods → drone steps (production quadrotor path
    with the rod force injected) + payload semi-implicit Euler."""
    h = dt / cfg.substeps
    inertia = cfg.payload_inertia
    # lump each bar's mass half onto the payload (the other half rides
    # with the drone implicitly through the rod tension at hover trim)
    m_pay = cfg.payload_mass + 0.5 * cfg.bar_mass * cfg.n_drones

    for _ in range(cfg.substeps):
        f_drone, f_pay_w, tau_pay_w = _rod_forces(cfg, state)
        drones, _ = drone_step(
            params, state.drones, rotor_cmds, h, body_cfg,
            enable_downwash=True, ext_force_w=f_drone,
        )
        # payload rigid body (PhysX-equivalent semi-implicit Euler,
        # damped like set_rigid_body_properties 0.1/0.1)
        acc = f_pay_w / m_pay + jnp.asarray([0.0, 0.0, -9.81])
        vel = (state.payload_vel + h * acc) * max(
            0.0, 1.0 - cfg.linear_damping * h
        )
        pos = state.payload_pos + h * vel
        tau_b = quat_rotate(
            _quat_conj(state.payload_quat), tau_pay_w
        )
        om = state.payload_omega
        ang_acc = (tau_b - jnp.cross(om, inertia * om)) / inertia
        om = (om + h * ang_acc) * max(0.0, 1.0 - cfg.angular_damping * h)
        dq = quat_mul(
            state.payload_quat,
            jnp.concatenate([jnp.zeros_like(om[..., :1]), om], axis=-1),
        ) * 0.5
        quat = state.payload_quat + h * dq
        quat = quat / jnp.linalg.norm(quat, axis=-1, keepdims=True)
        state = TransportState(
            drones=drones, payload_pos=pos, payload_quat=quat,
            payload_vel=vel, payload_omega=om,
        )
    return state


def _quat_conj(q: jnp.ndarray) -> jnp.ndarray:
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0])


def make_transport_params(cfg: TransportCfg) -> QuadrotorParams:
    if cfg.drone_model not in DRONE_ZOO:
        raise KeyError(f"unknown drone model {cfg.drone_model!r}")
    return make_params(cfg.drone_model)
