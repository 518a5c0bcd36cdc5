"""Hover task: single drone stabilizes at a fixed point with fixed heading.

Pure-JAX port of the reference Hover environment
(omni_drones/envs/single/hover.py:40-523): same observation layout, reward
terms, CTBR telemetry stats, and randomized initial pose.  The whole env —
dynamics, PID-rate transform, reward, auto-reset — is one statically-shaped
step function.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from typing import Any, Optional

from ..core import struct
from ..controllers import PIDRateState
from ..core import euler_to_quaternion
from ..dynamics import DroneState, RigidBodyCfg, hover_state, make_params
from ..dynamics.randomization import (
    RandomizationCfg,
    intrinsics_vector,
    randomize_params,
)
from ..dynamics import step as dynamics_step
from ..transforms.ctbr import hover_prev_action_init, pid_rate_transform
from ..transforms.obs import history_init, history_push
from .base import Transition, register_env, where_done


@dataclasses.dataclass(frozen=True)
class HoverCfg:
    """Task hyper-parameters (reference cfg/task/Hover.yaml)."""

    num_envs: int = 4096
    max_episode_length: int = 500
    dt: float = 0.01
    drone_model: str = "crazyflie"
    reward_distance_scale: float = 10.0
    reward_v_scale: float = 0.0
    reward_acc_scale: float = 0.0
    reward_jerk_scale: float = 0.0
    linear_vel_max: float = 3.0
    linear_acc_max: float = 10.0
    time_encoding_dim: int = 4
    # sim2real options (reference cfg/task/Hover.yaml:31-34 + hover.py:339,423-428)
    action_noise: bool = False
    obs_noise: bool = False
    latency: bool = False          # 2-step observation delay (hover.py:211-212,426-428)
    # payload randomization (hover.py:18-35,99-114,300-313; z/mass ranges
    # from the commented defaults in cfg/task/Hover.yaml)
    payload: bool = False
    payload_z_range: Tuple[float, float] = (-0.1, 0.1)
    payload_mass_range: Tuple[float, float] = (0.01, 0.1)  # × drone mass
    # observation options (hover.py:201-205, 376-379)
    obs_omega: bool = False
    obs_motor: bool = False
    # domain randomization ranges (MultirotorBase.setup_randomization /
    # _randomize, multirotor.py:406-697): any non-None range enables per-env
    # resampling at every reset and the privileged `intrinsics` observation
    # branch consumed by ppo(priv)/ppo_adapt.  CLI syntax: env.dr_mass_scale='[0.8,1.2]'
    dr_mass_scale: Optional[Tuple[float, float]] = None
    dr_inertia_scale: Optional[Tuple[float, float]] = None
    dr_t2w_scale: Optional[Tuple[float, float]] = None
    dr_f2m_scale: Optional[Tuple[float, float]] = None
    dr_drag_scale: Optional[Tuple[float, float]] = None
    dr_rotor_offset_scale: Optional[Tuple[float, float]] = None
    dr_tau_up: Optional[Tuple[float, float]] = None
    dr_tau_down: Optional[Tuple[float, float]] = None
    # sliding obs-history window ("observation_h", the History transform
    # transforms.py:493-553) consumed by ppo_tconv / ppo_adapt; 0 = off
    obs_history_len: int = 0
    # onboard depth camera observation ("depth", [E, 1, H, W, 1] in [0,1])
    # rendered by the analytic ray-cast sensor (sensors/depth.py) and
    # consumed by the ppo_vision policy (MixedObsEncoder vision branch).
    # Parity-plus: the reference camera is viz-only (sensors/camera.py:40).
    obs_depth: bool = False
    depth_width: int = 32
    depth_height: int = 24
    depth_max_range: float = 8.0

    @property
    def use_dr(self) -> bool:
        return any(
            getattr(self, f) is not None
            for f in (
                "dr_mass_scale", "dr_inertia_scale", "dr_t2w_scale",
                "dr_f2m_scale", "dr_drag_scale", "dr_rotor_offset_scale",
                "dr_tau_up", "dr_tau_down",
            )
        )

    @property
    def rand_cfg(self) -> RandomizationCfg:
        return RandomizationCfg(
            mass_scale=self.dr_mass_scale,
            inertia_scale=self.dr_inertia_scale,
            t2w_scale=self.dr_t2w_scale,
            f2m_scale=self.dr_f2m_scale,
            drag_coef_scale=self.dr_drag_scale,
            rotor_offset_scale=self.dr_rotor_offset_scale,
            tau_up=self.dr_tau_up,
            tau_down=self.dr_tau_down,
        )

    @property
    def intrinsics_dim(self) -> int:
        # mass(1)+inertia(3)+KF(4)+KM(4)+tau_up(4)+tau_down(4)+drag(1)+offset(1)
        # (intrinsics_spec, multirotor.py:78-88)
        return 22

    @property
    def obs_is_dict(self) -> bool:
        return self.use_dr or self.obs_history_len > 0 or self.obs_depth

    @property
    def latency_steps(self) -> int:
        return 2 if self.latency else 0

    @property
    def obs_dim(self) -> int:
        # rpos(3) + quat+vel(7) + heading+up(6) [+omega(3)] [+motor(4)] + time
        # (hover.py:194-209)
        return (
            3 + 7 + 6
            + (3 if self.obs_omega else 0)
            + (4 if self.obs_motor else 0)
            + self.time_encoding_dim
        )


STAT_KEYS = (
    "return",
    "pos_error",
    "heading_alignment",
    "uprightness",
    "action_smoothness",
    "episode_len",
    "reward_pos",
    "pos_bonus",
    "head_bonus",
    "linear_v_max",
    "angular_v_max",
    "linear_a_max",
    "angular_a_max",
    "linear_jerk_max",
    "angular_jerk_max",
    "linear_v_mean",
    "angular_v_mean",
    "linear_a_mean",
    "angular_a_mean",
    "linear_jerk_mean",
    "angular_jerk_mean",
    "action_error_order1_mean",
    # CTBR telemetry (hover.py:355-370): commanded vs realized body rates
    # [deg/s] and raw motor-channel actions, overwritten every step
    "target_r_rate",
    "target_p_rate",
    "target_y_rate",
    "real_r_rate",
    "real_p_rate",
    "real_y_rate",
    "motor1",
    "motor2",
    "motor3",
    "motor4",
)


@struct.dataclass
class HoverState:
    drone: DroneState           # [E, 1, ·]
    pid: PIDRateState           # [E, 1, ·]
    prev_action: jnp.ndarray    # [E, 1, 4]
    target_pos: jnp.ndarray     # [E, 1, 3]
    target_heading: jnp.ndarray # [E, 1, 3]
    progress: jnp.ndarray       # [E]
    stats: Dict[str, jnp.ndarray]
    # smoothness trackers (hover.py:150-155)
    last_linear_v: jnp.ndarray
    last_angular_v: jnp.ndarray
    last_linear_a: jnp.ndarray
    last_angular_a: jnp.ndarray
    key: jnp.ndarray
    # payload randomization (zeros when cfg.payload=False): point mass [kg]
    # rigidly carried at body-frame offset (0, 0, z)  (hover.py:300-313)
    payload_mass: jnp.ndarray   # [E, 1, 1]
    payload_z: jnp.ndarray      # [E, 1, 1]
    # observation latency ring buffer, oldest first  (hover.py:211-212)
    obs_buf: jnp.ndarray        # [E, L, 1, obs_dim] (L = 0 when latency off)
    # domain randomization (None unless cfg.use_dr): per-env dynamics params
    # with [E, 1, ...] leaves + normalized intrinsics (multirotor.py:652-697)
    dyn_params: Any = None      # QuadrotorParams pytree
    intrinsics: Any = None      # [E, 1, 22]
    # sliding obs-history window (None unless cfg.obs_history_len > 0)
    obs_h: Any = None           # [E, 1, H, obs_dim]


@register_env("Hover")
class Hover:
    """Vectorized hover env; all methods are pure and jit-safe."""

    def __init__(self, cfg: HoverCfg = HoverCfg()):
        self.cfg = cfg
        self.params = make_params(cfg.drone_model)
        self.rigid_cfg = RigidBodyCfg(max_linear_velocity=1000.0)
        self.num_agents = 1
        self.action_dim = 4

    # -- spec-ish metadata ------------------------------------------------
    @property
    def obs_dim(self) -> int:
        return self.cfg.obs_dim

    @property
    def num_envs(self) -> int:
        return self.cfg.num_envs

    # -- reset ------------------------------------------------------------
    def _sample_drone_state(
        self, key: jnp.ndarray, batch: Tuple[int, ...], params=None
    ) -> DroneState:
        """Initial pose: pos ~ U([-1,-1,0.05],[1,1,2]), rpy ~ U(±0.2π, yaw
        [0, 0.5π]) (hover.py:129-140).  `params` may be the per-env
        randomized params so the initial throttle is the true hover
        equilibrium (multirotor.py:647-648 uses the randomized KF)."""
        k_pos, k_rpy = jax.random.split(key)
        pos = jax.random.uniform(
            k_pos,
            batch + (3,),
            minval=jnp.asarray([-1.0, -1.0, 0.05]),
            maxval=jnp.asarray([1.0, 1.0, 2.0]),
        )
        rpy = jax.random.uniform(
            k_rpy,
            batch + (3,),
            minval=jnp.asarray([-0.2, -0.2, 0.0]) * jnp.pi,
            maxval=jnp.asarray([0.2, 0.2, 0.5]) * jnp.pi,
        )
        return hover_state(
            params if params is not None else self.params,
            pos, euler_to_quaternion(rpy),
        )

    def _sample_dr(self, key: jnp.ndarray):
        """Per-env randomized dynamics params + normalized intrinsics vector
        (MultirotorBase._randomize, multirotor.py:652-697); (None, None)
        when randomization is off."""
        cfg = self.cfg
        if not cfg.use_dr:
            return None, None
        params, intr = randomize_params(
            key, self.params, cfg.rand_cfg, cfg.num_envs
        )
        return params, intrinsics_vector(intr)

    def _sample_payload(
        self, key: jnp.ndarray, batch: Tuple[int, ...]
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Payload mass (× drone mass) and body-frame z offset (hover.py:300-313)."""
        cfg = self.cfg
        if not cfg.payload:
            z = jnp.zeros(batch + (1,))
            return z, z
        k_m, k_z = jax.random.split(key)
        mass = self.params.mass * jax.random.uniform(
            k_m, batch + (1,), minval=cfg.payload_mass_range[0],
            maxval=cfg.payload_mass_range[1],
        )
        z = jax.random.uniform(
            k_z, batch + (1,), minval=cfg.payload_z_range[0],
            maxval=cfg.payload_z_range[1],
        )
        return mass, z

    def reset(self, key: jnp.ndarray) -> HoverState:
        e = self.cfg.num_envs
        k_init, k_payload, k_dr, k_next = jax.random.split(key, 4)
        dyn_params, intrinsics = self._sample_dr(k_dr)
        drone = self._sample_drone_state(k_init, (e, 1), dyn_params)
        payload_mass, payload_z = self._sample_payload(k_payload, (e, 1))
        zeros1 = jnp.zeros((e, 1))
        state = HoverState(
            drone=drone,
            pid=PIDRateState.zeros((e, 1)),
            prev_action=hover_prev_action_init(self.params, drone.throttle),
            target_pos=jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (e, 1, 3)),
            target_heading=jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), (e, 1, 3)),
            progress=jnp.zeros((e,), jnp.int32),
            stats={k: zeros1 for k in STAT_KEYS},
            last_linear_v=zeros1,
            last_angular_v=zeros1,
            last_linear_a=zeros1,
            last_angular_a=zeros1,
            key=k_next,
            payload_mass=payload_mass,
            payload_z=payload_z,
            obs_buf=jnp.zeros((e, self.cfg.latency_steps, 1, self.cfg.obs_dim)),
            dyn_params=dyn_params,
            intrinsics=intrinsics,
        )
        if self.cfg.latency:
            obs0 = self._observe_now(state)
            state = state.replace(
                obs_buf=jnp.broadcast_to(
                    obs0[:, None], (e, self.cfg.latency_steps, 1, self.cfg.obs_dim)
                )
            )
        if self.cfg.obs_history_len > 0:
            state = state.replace(
                obs_h=history_init(
                    self._flat_obs(state), self.cfg.obs_history_len
                )
            )
        return state

    # -- observation ------------------------------------------------------
    def _observe_now(self, state: HoverState) -> jnp.ndarray:
        """Instantaneous [rpos, quat, vel_w, heading, up, (omega), (motor), t]
        (hover.py:371-383)."""
        d = state.drone
        rpos = state.target_pos - d.pos
        t = (state.progress / self.cfg.max_episode_length)[:, None, None]
        parts = [rpos, d.quat, d.vel, d.heading, d.up]
        if self.cfg.obs_omega:
            parts.append(d.angvel)
        if self.cfg.obs_motor:
            parts.append(d.throttle * 2.0 - 1.0)
        parts.append(
            jnp.broadcast_to(t, (self.cfg.num_envs, 1, self.cfg.time_encoding_dim))
        )
        return jnp.concatenate(parts, axis=-1)

    def _flat_obs(self, state: HoverState) -> jnp.ndarray:
        """The flat policy observation — the latency-buffer head when the
        2-step delay is enabled (hover.py:426-428)."""
        if self.cfg.latency:
            return state.obs_buf[:, 0]
        return self._observe_now(state)

    def observe(self, state: HoverState):
        """Policy-visible observation.  A flat array normally; a dict with
        the privileged `intrinsics` branch (multirotor.py:78-88) and/or the
        sliding `observation_h` window (the History transform,
        transforms.py:493-553) when domain randomization / obs history are
        enabled — the layout ppo(priv)/ppo_adapt/ppo_tconv consume."""
        if not self.cfg.obs_is_dict:
            return self._flat_obs(state)
        obs = {"observation": self._flat_obs(state)}
        if self.cfg.use_dr:
            obs["intrinsics"] = state.intrinsics
        if self.cfg.obs_history_len > 0:
            obs["observation_h"] = state.obs_h
        if self.cfg.obs_depth:
            obs["depth"] = self._depth_obs(state)
        return obs

    def _depth_obs(self, state: HoverState) -> jnp.ndarray:
        """Onboard depth frame [E, 1, H, W, 1] in [0, 1]: analytic ray cast
        against ground plane + target sphere, normalized by DepthImageNorm
        semantics (transforms.py:250-270)."""
        from ..sensors.depth import DepthCameraCfg, depth_image
        from ..transforms.obs import depth_image_norm

        cam = DepthCameraCfg(
            width=self.cfg.depth_width,
            height=self.cfg.depth_height,
            max_range=self.cfg.depth_max_range,
        )
        d = state.drone
        depth = depth_image(
            cam, d.pos, d.quat,
            target_pos=state.target_pos, target_radius=0.25,
        )
        return depth_image_norm(depth, cam.min_range, cam.max_range)[..., None]

    # -- step -------------------------------------------------------------
    def step(
        self, state: HoverState, action: jnp.ndarray, key: jnp.ndarray
    ) -> Tuple[HoverState, Transition]:
        cfg = self.cfg
        params = self.params
        k_anoise, k_onoise, k_payload, k_init, k_dr, k_next = jax.random.split(
            key, 6
        )

        # multiplicative action noise (hover.py:339-340)
        if cfg.action_noise:
            action = action * (
                jax.random.normal(k_anoise, action.shape) * 0.1 + 1.0
            )

        # (L4) CTBR action adapter + firmware PID (transforms.py:404-459)
        res = pid_rate_transform(
            params, state.drone, action, state.prev_action, state.pid, cfg.dt
        )
        # payload = point mass rigidly carried at body offset (0,0,z): adds
        # mass and a parallel-axis inertia term (the reference attaches a
        # dynamic cuboid through a limited prismatic joint, hover.py:18-35)
        # per-env randomized params (domain randomization) when enabled;
        # the PID-rate transform above keeps the NOMINAL params — the real
        # firmware does not know the perturbed physics (the sim2real premise,
        # multirotor.py:406-697).
        base_params = state.dyn_params if cfg.use_dr else params
        if cfg.payload:
            mp = state.payload_mass[..., 0]            # [E,1]
            zp = state.payload_z                       # [E,1,1]
            d_inertia = mp[..., None] * jnp.square(zp) * jnp.asarray([1.0, 1.0, 0.0])
            dyn_params = base_params.replace(
                mass=base_params.mass + mp,
                inertia=base_params.inertia + d_inertia,
            )
        else:
            dyn_params = base_params
        drone, throttle_diff = dynamics_step(
            dyn_params, state.drone, res.rotor_cmds, cfg.dt, self.rigid_cfg,
            enable_downwash=False,
        )
        progress = state.progress + 1

        # reward (hover.py:439-498)
        rpos = state.target_pos - drone.pos
        pos_error = jnp.linalg.norm(rpos, axis=-1)
        rheading = state.target_heading - drone.heading
        head_error = jnp.linalg.norm(rheading, axis=-1)
        heading_alignment = jnp.sum(drone.heading * state.target_heading, axis=-1)

        reward_pos = -pos_error * cfg.reward_distance_scale
        pos_bonus = (pos_error <= 0.02).astype(jnp.float32) * 10.0
        reward_head = -head_error * (pos_bonus > 0)
        head_bonus = (head_error <= 0.02).astype(jnp.float32) * 10.0 * (pos_bonus > 0)
        reward_up = jnp.square((drone.up[..., 2] + 1.0) * 0.5)

        linear_v = jnp.linalg.norm(drone.vel, axis=-1)
        angular_v = jnp.linalg.norm(drone.angvel, axis=-1)
        linear_a = jnp.abs(linear_v - state.last_linear_v) / cfg.dt
        angular_a = jnp.abs(angular_v - state.last_angular_v) / cfg.dt
        linear_jerk = jnp.abs(linear_a - state.last_linear_a) / cfg.dt
        angular_jerk = jnp.abs(angular_a - state.last_angular_a) / cfg.dt

        reward_v = cfg.reward_v_scale * (pos_bonus > 0) * (linear_v < cfg.linear_vel_max)
        reward_acc = (
            cfg.reward_acc_scale * (pos_bonus > 0) * (linear_a < cfg.linear_acc_max)
        )
        reward_jerk = cfg.reward_jerk_scale * (pos_bonus > 0) * (-linear_jerk)

        reward = (
            reward_pos + pos_bonus + reward_head + head_bonus + reward_up
            + reward_v + reward_acc + reward_jerk
        )
        done_env = progress >= cfg.max_episode_length  # [E]
        done = done_env[:, None]

        # stats (EMA'd / maxed per hover.py:386-513)
        alpha = 0.8
        pcount = progress.astype(jnp.float32)[:, None]
        st = dict(state.stats)
        st["return"] = st["return"] + reward
        st["pos_error"] = st["pos_error"] + (1 - alpha) * (pos_error - st["pos_error"])
        st["heading_alignment"] = st["heading_alignment"] + (1 - alpha) * (
            heading_alignment - st["heading_alignment"]
        )
        st["uprightness"] = st["uprightness"] + (1 - alpha) * (
            drone.up[..., 2] - st["uprightness"]
        )
        st["action_smoothness"] = st["action_smoothness"] + (1 - alpha) * (
            -throttle_diff - st["action_smoothness"]
        )
        st["episode_len"] = pcount * jnp.ones_like(st["episode_len"])
        st["reward_pos"] = reward_pos
        st["pos_bonus"] = pos_bonus
        st["head_bonus"] = head_bonus
        for name, cur in (
            ("linear_v", linear_v),
            ("angular_v", angular_v),
            ("linear_a", linear_a),
            ("angular_a", angular_a),
            ("linear_jerk", linear_jerk),
            ("angular_jerk", angular_jerk),
        ):
            st[f"{name}_max"] = jnp.maximum(st[f"{name}_max"], jnp.abs(cur))
            st[f"{name}_mean"] = st[f"{name}_mean"] + (
                jnp.abs(cur) - st[f"{name}_mean"]
            ) / pcount
        st["action_error_order1_mean"] = st["action_error_order1_mean"] + (
            res.action_error - st["action_error_order1_mean"]
        ) / pcount
        # CTBR telemetry: commanded and realized body rates [deg/s] + raw
        # motor-channel actions, overwritten every step (hover.py:341-370)
        body_rate_deg = drone.body_rate * (180.0 / jnp.pi)
        for i, ax in enumerate(("r", "p", "y")):
            st[f"target_{ax}_rate"] = res.target_rate_deg[..., i]
            st[f"real_{ax}_rate"] = body_rate_deg[..., i]
        for i in range(4):
            st[f"motor{i + 1}"] = action[..., i]

        mid_state = state.replace(
            drone=drone,
            pid=res.pid_state,
            prev_action=res.ctbr_action,
            progress=progress,
            stats=st,
            last_linear_v=linear_v,
            last_angular_v=angular_v,
            last_linear_a=linear_a,
            last_angular_a=angular_a,
        )

        # auto-reset (isaac_env.py:210-225 semantics): done envs get fresh
        # state (incl. zeroed stats); Transition.stats keeps the finished values
        fresh_params, fresh_intr = self._sample_dr(k_dr)
        fresh_drone = self._sample_drone_state(
            k_init, (cfg.num_envs, 1), fresh_params
        )
        fresh_pm, fresh_pz = self._sample_payload(k_payload, (cfg.num_envs, 1))
        zeros1 = jnp.zeros((cfg.num_envs, 1))
        sel = lambda new, old: where_done(done_env, new, old)
        new_state = mid_state.replace(
            drone=sel(fresh_drone, drone),
            pid=sel(PIDRateState.zeros((cfg.num_envs, 1)), res.pid_state),
            prev_action=sel(
                hover_prev_action_init(params, fresh_drone.throttle), res.ctbr_action
            ),
            progress=jnp.where(done_env, 0, progress),
            stats=sel({k: zeros1 for k in STAT_KEYS}, st),
            last_linear_v=sel(zeros1, linear_v),
            last_angular_v=sel(zeros1, angular_v),
            last_linear_a=sel(zeros1, linear_a),
            last_angular_a=sel(zeros1, angular_a),
            payload_mass=sel(fresh_pm, state.payload_mass),
            payload_z=sel(fresh_pz, state.payload_z),
            key=k_next,
        )
        if cfg.use_dr:
            # some QuadrotorParams leaves stay unbatched (directions,
            # max_thrust_ratio, …) — select only the per-env ones
            e = cfg.num_envs

            def sel_leaf(x, y):
                if jnp.ndim(x) >= 1 and x.shape[0] == e:
                    d = done_env.reshape((e,) + (1,) * (jnp.ndim(x) - 1))
                    return jnp.where(d, x, y)
                return y

            new_state = new_state.replace(
                dyn_params=jax.tree_util.tree_map(
                    sel_leaf, fresh_params, state.dyn_params
                ),
                intrinsics=sel(fresh_intr, state.intrinsics),
            )
        inst_obs = self._observe_now(new_state)
        # multiplicative observation noise, applied before the latency buffer
        # (hover.py:423-428); the reference's deque is likewise never cleared
        # per-env at reset.
        if cfg.obs_noise:
            inst_obs = inst_obs * (
                jax.random.normal(k_onoise, inst_obs.shape) * 0.1 + 1.0
            )
        if cfg.latency:
            new_buf = jnp.concatenate(
                [state.obs_buf[:, 1:], inst_obs[:, None]], axis=1
            )
            new_state = new_state.replace(obs_buf=new_buf)
            obs = new_buf[:, 0]
        else:
            obs = inst_obs

        # sliding obs-history window: slide one frame, refill on reset
        # (History transform semantics, transforms.py:493-553)
        if cfg.obs_history_len > 0:
            pushed = history_push(state.obs_h, obs)
            new_state = new_state.replace(
                obs_h=where_done(
                    done_env, history_init(obs, cfg.obs_history_len), pushed
                )
            )
        if cfg.obs_is_dict:
            obs = {"observation": obs}
            if cfg.use_dr:
                obs["intrinsics"] = new_state.intrinsics
            if cfg.obs_history_len > 0:
                obs["observation_h"] = new_state.obs_h
            if cfg.obs_depth:
                obs["depth"] = self._depth_obs(new_state)

        info = {
            "drone_state": drone.state_vector()[..., :13],
            "ctbr": res.ctbr,
            "prev_action": new_state.prev_action,
        }
        return new_state, Transition(
            obs=obs,
            reward=reward[..., None],
            done=done,
            stats=st,
            info=info,
        )
