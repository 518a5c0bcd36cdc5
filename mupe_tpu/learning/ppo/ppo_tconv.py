"""PPO with a temporal-convolution encoder over stacked observation history.

Counterpart of omni_drones/learning/ppo/ppo_tconv.py:77-261: obs histories
(the `History` transform's sliding stack) are encoded by a 1-D conv stack
[64 k1, 64 k7 s2, 64 k5 s2] with ELU, flattened, then fed to the standard
PPO heads.
"""
from __future__ import annotations

import jax.numpy as jnp
from flax import linen as nn

from ..mappo import MAPPOCfg, MAPPOPolicy
from ..modules.distributions import Gaussian
from ..modules.linen import MLP, DiagGaussianHead


class TConvEncoder(nn.Module):
    """x: (..., T, D) → (..., F) — the TConv of ppo_tconv.py:77-90.

    Conv1d over the time axis with channels-last layout (flax convention).
    """

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        batch_shape = x.shape[:-2]
        h = x.reshape((-1,) + x.shape[-2:])         # [B, T, D]
        h = nn.Conv(64, kernel_size=(1,))(h)
        h = nn.elu(h)
        h = nn.Conv(64, kernel_size=(7,), strides=(2,), padding="VALID")(h)
        h = nn.elu(h)
        h = nn.Conv(64, kernel_size=(5,), strides=(2,), padding="VALID")(h)
        h = nn.elu(h)
        h = h.reshape(batch_shape + (-1,))
        return MLP((256,))(h)


class _TConvActor(nn.Module):
    action_dim: int

    @nn.compact
    def __call__(self, obs) -> Gaussian:
        x = obs["observation_h"] if isinstance(obs, dict) else obs
        return DiagGaussianHead(self.action_dim)(TConvEncoder()(x))


class _TConvCritic(nn.Module):
    @nn.compact
    def __call__(self, obs) -> jnp.ndarray:
        x = obs["observation_h"] if isinstance(obs, dict) else obs
        return nn.Dense(1, kernel_init=nn.initializers.orthogonal(0.01))(
            TConvEncoder()(x)
        )


class PPOTConvPolicy(MAPPOPolicy):
    """Expects observations of shape (..., history, obs_dim) — produced by
    the `history_stack` transform (transforms/history.py)."""

    def __init__(
        self,
        cfg: MAPPOCfg = MAPPOCfg(gamma=0.99, use_tp_net=False),
        n_agents: int = 1,
        action_dim: int = 4,
        obs_is_dict: bool = False,
    ):
        super().__init__(
            cfg,
            n_agents=n_agents,
            action_dim=action_dim,
            obs_is_dict=obs_is_dict,
            actor_module=_TConvActor(action_dim),
            critic_module=_TConvCritic(),
        )
