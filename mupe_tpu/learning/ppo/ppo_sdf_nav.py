"""PPO with a PointNet encoder over SDF point observations.

Counterpart of omni_drones/learning/ppo/ppo_sdf_nav.py:65-242: per-point MLP
`h`, max-pool over points, projection `gamma`, concatenated with the flat
state features before the PPO heads.
"""
from __future__ import annotations

import jax.numpy as jnp
from flax import linen as nn

from ..mappo import MAPPOCfg, MAPPOPolicy
from ..modules.distributions import Gaussian
from ..modules.linen import MLP, DiagGaussianHead


class PointNetEncoder(nn.Module):
    """points: (..., P, 3) → (..., out_dim) (ppo_sdf_nav.py:65-74)."""

    out_dim: int = 128

    @nn.compact
    def __call__(self, points: jnp.ndarray) -> jnp.ndarray:
        h = MLP((64, 64))(points)          # per-point features
        pooled = jnp.max(h, axis=-2)       # symmetric max pool over points
        return MLP((self.out_dim,))(pooled)


class _SDFNavBody(nn.Module):
    @nn.compact
    def __call__(self, obs: dict) -> jnp.ndarray:
        pts = PointNetEncoder()(obs["sdf_points"])
        state = MLP((128, 128))(obs["observation"])
        return MLP((256, 256))(jnp.concatenate([pts, state], axis=-1))


class _SDFNavActor(nn.Module):
    action_dim: int

    @nn.compact
    def __call__(self, obs: dict) -> Gaussian:
        return DiagGaussianHead(self.action_dim)(_SDFNavBody()(obs))


class _SDFNavCritic(nn.Module):
    @nn.compact
    def __call__(self, obs: dict) -> jnp.ndarray:
        return nn.Dense(1, kernel_init=nn.initializers.orthogonal(0.01))(
            _SDFNavBody()(obs)
        )


class PPOSDFNavPolicy(MAPPOPolicy):
    """Observations: {"observation": flat state, "sdf_points": (..., P, 3)}."""

    def __init__(
        self,
        cfg: MAPPOCfg = MAPPOCfg(gamma=0.99, use_tp_net=False),
        n_agents: int = 1,
        action_dim: int = 4,
    ):
        super().__init__(
            cfg,
            n_agents=n_agents,
            action_dim=action_dim,
            obs_is_dict=True,
            actor_module=_SDFNavActor(action_dim),
            critic_module=_SDFNavCritic(),
        )
