"""Transformer-token PPO over entity observations (the reference's "test" algo).

Counterpart of omni_drones/learning/_ppo.py:48-239: each observation group
is projected to 128-d tokens (Linear-ELU-Linear-LayerNorm per key), a
TransformerEncoder mixes all tokens, and per-agent heads read the first `n`
tokens (agent tokens come first), concatenating raw token + mixed feature.
"""
from __future__ import annotations

from typing import Dict

import jax.numpy as jnp
from flax import linen as nn

from ..mappo import MAPPOCfg, MAPPOPolicy
from ..modules.distributions import Gaussian
from ..modules.linen import MLP, DiagGaussianHead


class _TokenEmbed(nn.Module):
    """Per-key Linear→ELU→Linear→LayerNorm projections (make_embed,
    _ppo.py:48-67), concatenated along the token axis."""

    embed_dim: int = 128

    @nn.compact
    def __call__(self, obs: Dict[str, jnp.ndarray]) -> jnp.ndarray:
        tokens = []
        for key in obs.keys():
            if key == "mask":
                continue
            h = nn.Dense(self.embed_dim, name=f"proj1_{key}")(obs[key])
            h = nn.elu(h)
            h = nn.Dense(self.embed_dim, name=f"proj2_{key}")(h)
            h = nn.LayerNorm(name=f"norm_{key}")(h)
            tokens.append(h)
        return jnp.concatenate(tokens, axis=-2)


class TransformerEncoder(nn.Module):
    """Pre-norm transformer blocks over the token axis."""

    embed_dim: int = 128
    num_heads: int = 4
    num_layers: int = 2
    dim_feedforward: int = 256

    @nn.compact
    def __call__(self, tokens: jnp.ndarray) -> jnp.ndarray:
        x = tokens
        for i in range(self.num_layers):
            y = nn.LayerNorm()(x)
            y = nn.MultiHeadDotProductAttention(
                num_heads=self.num_heads, qkv_features=self.embed_dim,
                name=f"attn_{i}",
            )(y, y)
            x = x + y
            y = nn.LayerNorm()(x)
            y = nn.Dense(self.dim_feedforward)(y)
            y = nn.gelu(y)
            y = nn.Dense(self.embed_dim)(y)
            x = x + y
        return x


class _TransformerActor(nn.Module):
    """Per-agent Gaussian head over [token ⊕ feature] (_ppo.py:69-90).

    Two obs layouts:
      * global token set per env (`per_agent_obs=False`): leaves
        ``[..., k_i, d]`` with the n agent tokens first — read the first n
        mixed tokens, one action each (the reference `_ppo` semantics);
      * per-agent entity dicts (`per_agent_obs=True`, the HideAndSeek
        layout): leaves ``[..., n, k_i, d]`` where token 0 of each agent's
        set is its self token — read that token, one action per agent.
    """

    n_agents: int
    action_dim: int
    per_agent_obs: bool = False

    @nn.compact
    def __call__(self, obs: Dict[str, jnp.ndarray]) -> Gaussian:
        tokens = _TokenEmbed()(obs)
        feats = TransformerEncoder()(tokens)
        n = 1 if self.per_agent_obs else self.n_agents
        x = jnp.concatenate(
            [tokens[..., :n, :], feats[..., :n, :]], axis=-1
        )
        if self.per_agent_obs:
            x = x[..., 0, :]
        x = MLP((128, 128))(x)
        return DiagGaussianHead(self.action_dim)(x)


class _TransformerCritic(nn.Module):
    """Per-agent values from the first n mixed tokens (_ppo.py:93-106)."""

    n_agents: int
    per_agent_obs: bool = False

    @nn.compact
    def __call__(self, obs: Dict[str, jnp.ndarray]) -> jnp.ndarray:
        tokens = _TokenEmbed()(obs)
        feats = TransformerEncoder()(tokens)
        if self.per_agent_obs:
            x = MLP((128, 128))(feats[..., 0, :])
            return nn.Dense(1, kernel_init=nn.initializers.orthogonal(0.01))(x)
        x = MLP((128, 128))(feats[..., : self.n_agents, :])
        v = nn.Dense(1, kernel_init=nn.initializers.orthogonal(0.01))(x)
        return v[..., 0, :] if self.n_agents == 1 else v


class TransformerPPOPolicy(MAPPOPolicy):
    """Entity-token PPO.  Observations are dicts of (..., k_i, d_i) groups
    with agent tokens first; actions come out per agent.

    Note: unlike the attention-MAPPO layout ([E, n, …] with per-agent
    sub-dicts), this policy consumes one *global* token set per env and
    emits n actions — the reference's `_ppo` semantics.
    """

    def __init__(
        self,
        cfg: MAPPOCfg = MAPPOCfg(use_tp_net=False),
        n_agents: int = 1,
        action_dim: int = 4,
        per_agent_obs: bool = False,
    ):
        super().__init__(
            cfg,
            n_agents=n_agents,
            action_dim=action_dim,
            obs_is_dict=True,
            actor_module=_TransformerActor(n_agents, action_dim, per_agent_obs),
            critic_module=_TransformerCritic(n_agents, per_agent_obs),
        )
