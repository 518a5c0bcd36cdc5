"""Single-agent PPO with optional privileged-intrinsics branches.

Counterpart of omni_drones/learning/ppo/ppo.py:42-249 (`PPOConfig`,
`PPOPolicy`): γ=0.99/λ=0.95 PPO-clip with Huber value loss, flat MLP
encoders, and (with `priv_actor`/`priv_critic`) a second branch that embeds
the drone's physical intrinsics (mass/inertia/KF/… from domain
randomization, multirotor.py:78-88) into a context vector concatenated with
the observation features.

Built on the shared `MAPPOPolicy` machinery with injected modules — the
reference's torchrl `TensorDictSequential` graphs become small flax modules
over (obs, intrinsics) dict observations.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax.numpy as jnp
from flax import linen as nn

from ..mappo import MAPPOCfg, MAPPOPolicy
from ..modules.distributions import Gaussian
from ..modules.linen import MLP, DiagGaussianHead


@dataclasses.dataclass(frozen=True)
class PPOCfg(MAPPOCfg):
    """PPO defaults (ppo.py:42-55 + hard-coded constants :92-97)."""

    train_every: int = 32
    ppo_epochs: int = 4
    num_minibatches: int = 16
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_param: float = 0.1
    entropy_coef: float = 0.001
    huber_delta: float = 10.0
    priv_actor: bool = False
    priv_critic: bool = False
    use_tp_net: bool = False


class _PrivBranch(nn.Module):
    """obs MLP [128,128] ⊕ LayerNorm+MLP[64,64] on intrinsics → MLP[256,256]
    (ppo.py:102-126)."""

    @nn.compact
    def __call__(self, obs: dict) -> jnp.ndarray:
        feat = MLP((128, 128))(obs["observation"])
        ctx = nn.LayerNorm()(obs["intrinsics"])
        ctx = MLP((64, 64))(ctx)
        x = jnp.concatenate([feat, ctx], axis=-1)
        return MLP((256, 256))(x)


class _PrivActor(nn.Module):
    action_dim: int

    @nn.compact
    def __call__(self, obs: dict) -> Gaussian:
        return DiagGaussianHead(self.action_dim)(_PrivBranch()(obs))


class _PrivCritic(nn.Module):
    @nn.compact
    def __call__(self, obs: dict) -> jnp.ndarray:
        return nn.Dense(1, kernel_init=nn.initializers.orthogonal(0.01))(
            _PrivBranch()(obs)
        )


class _FlatActor(nn.Module):
    action_dim: int

    @nn.compact
    def __call__(self, obs) -> Gaussian:
        x = obs["observation"] if isinstance(obs, dict) else obs
        return DiagGaussianHead(self.action_dim)(MLP((256, 256, 256))(x))


class _FlatCritic(nn.Module):
    @nn.compact
    def __call__(self, obs) -> jnp.ndarray:
        x = obs["observation"] if isinstance(obs, dict) else obs
        return nn.Dense(1, kernel_init=nn.initializers.orthogonal(0.01))(
            MLP((256, 256, 256))(x)
        )


class PPOPolicy(MAPPOPolicy):
    """Single-agent PPO; observations may be flat arrays or
    {"observation", "intrinsics"} dicts when privileged branches are on."""

    def __init__(
        self,
        cfg: PPOCfg = PPOCfg(),
        n_agents: int = 1,
        action_dim: int = 4,
        obs_is_dict: bool = False,
    ):
        actor = (
            _PrivActor(action_dim) if cfg.priv_actor else _FlatActor(action_dim)
        )
        critic = _PrivCritic() if cfg.priv_critic else _FlatCritic()
        super().__init__(
            cfg,
            n_agents=n_agents,
            action_dim=action_dim,
            obs_is_dict=obs_is_dict,
            actor_module=actor,
            critic_module=critic,
        )
