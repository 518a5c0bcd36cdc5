"""Flax linen formulations of the MAPPO main-path networks.

The package runs these networks as plain init/apply functions
(learning/modules/networks.py, learning/mappo.py Actor/Critic,
learning/tp_net.py).  The linen versions below are the independent
formulation the tests hold them to: same param-tree paths and shapes, same
outputs within bf16 noise.  Import only after `pytest.importorskip("flax")`.
"""
from typing import Any, Dict, Sequence, Tuple

import jax.numpy as jnp
from flax import linen as nn

from mupe_tpu.learning.modules.linen import MLP, DiagGaussianHead, SplitEmbedding


class FlatEncoder(nn.Module):
    hidden_units: Sequence[int] = (256, 256, 256)
    layer_norm: bool = True
    dtype: Any = None

    @nn.compact
    def __call__(self, x):
        x = nn.LayerNorm(dtype=self.dtype)(x)
        return MLP(self.hidden_units, self.layer_norm, dtype=self.dtype)(x)


class PartialAttentionEncoder(nn.Module):
    embed_dim: int = 128
    num_heads: int = 1
    dim_feedforward: int = 128
    query_len: int = 1
    dtype: Any = None

    @nn.compact
    def __call__(self, obs: Dict[str, jnp.ndarray]):
        x = SplitEmbedding(self.embed_dim, dtype=self.dtype)(obs)
        q = x[..., : self.query_len, :]
        attn = nn.MultiHeadDotProductAttention(
            num_heads=self.num_heads, qkv_features=self.embed_dim,
            name="attn", dtype=self.dtype,
        )(q, x)
        y = nn.LayerNorm(dtype=self.dtype)(q + attn)
        ff = nn.Dense(self.dim_feedforward, dtype=self.dtype)(y)
        ff = nn.gelu(ff)
        ff = nn.Dense(self.embed_dim, dtype=self.dtype)(ff)
        y = nn.LayerNorm(dtype=self.dtype)(y + ff)
        return jnp.mean(y, axis=-2)


def _encoder(hidden_units, obs_is_dict, dtype):
    if obs_is_dict:
        return PartialAttentionEncoder(dtype=dtype)
    return FlatEncoder(tuple(hidden_units), dtype=dtype)


class Actor(nn.Module):
    action_dim: int
    hidden_units: Tuple[int, ...]
    obs_is_dict: bool
    dtype: Any = None

    @nn.compact
    def __call__(self, obs):
        feats = _encoder(self.hidden_units, self.obs_is_dict, self.dtype)(obs)
        return DiagGaussianHead(self.action_dim)(feats.astype(jnp.float32))


class Critic(nn.Module):
    out_dim: int
    hidden_units: Tuple[int, ...]
    obs_is_dict: bool
    dtype: Any = None

    @nn.compact
    def __call__(self, obs):
        feats = _encoder(self.hidden_units, self.obs_is_dict, self.dtype)(obs)
        return nn.Dense(
            self.out_dim, kernel_init=nn.initializers.orthogonal(0.01)
        )(feats.astype(jnp.float32))


class TPNet(nn.Module):
    """nn.RNN(OptimizedLSTMCell) over the window → Dense "fc" → tanh."""

    output_dim: int
    hidden_dim: int = 64
    dtype: Any = jnp.bfloat16

    @nn.compact
    def __call__(self, x):
        batch_shape = x.shape[:-2]
        xf = x.reshape((-1,) + x.shape[-2:])
        outs = nn.RNN(
            nn.OptimizedLSTMCell(self.hidden_dim, dtype=self.dtype),
            unroll=16, name="lstm",
        )(xf)
        y = nn.Dense(self.output_dim, name="fc")(outs[:, -1, :].astype(jnp.float32))
        return jnp.tanh(y).reshape(batch_shape + (self.output_dim,))
