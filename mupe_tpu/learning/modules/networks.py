"""Encoders of the MAPPO main path as plain init/apply functions.

Counterparts of the reference encoder family
(omni_drones/learning/modules/networks.py): `MLP` (:49-71), the flat-spec
`FlatEncoder` (learning/common.py:88-102), and `PartialAttentionEncoder`
(:250-313, the encoder of cfg/algo/mappo.yaml:33).  The relation encoders and
the vision branch are flax modules in `linen.py`.

Every module is a frozen dataclass with `init(key, x) -> {"params": tree}`
and `apply({"params": tree}, x)`.  The param trees keep the paths, shapes
and initializer families of the earlier flax modules, so checkpoints and
code that addresses leaves by path (`extract_leaves`, ".../log_std") are
unchanged.

Dict observations ({"state_self": [..,1,D₁], "state_others": [..,k,D₂], ...})
replace the reference's CompositeSpec tensordicts.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import jax
import jax.numpy as jnp

from ...ops.fused_encoder import EncoderSpec, _encode, encoder_leaves, pack_obs

_inits = jax.nn.initializers


class Module:
    """`init`/`apply` over `{"params": tree}` from a subclass's
    `params(key, x) -> tree` and `forward(tree, x)`."""

    def init(self, key, x) -> Dict[str, Any]:
        return {"params": self.params(key, x)}

    def apply(self, variables, x):
        return self.forward(variables["params"], x)


def dense_params(key, in_dim: int, out_dim: int, kernel_init=None) -> dict:
    """{"kernel", "bias"} of a flax-style Dense (lecun-normal, zero bias)."""
    kernel_init = kernel_init or _inits.lecun_normal()
    return {
        "kernel": kernel_init(key, (in_dim, out_dim), jnp.float32),
        "bias": jnp.zeros((out_dim,), jnp.float32),
    }


def dense(p, x, dtype=None):
    """x @ kernel + bias, computed in `dtype` (default: x's float type)."""
    dt = dtype or jnp.result_type(x, jnp.float32)
    return jnp.dot(x.astype(dt), p["kernel"].astype(dt)) + p["bias"].astype(dt)


def layer_norm_params(dim: int) -> dict:
    return {"scale": jnp.ones((dim,), jnp.float32), "bias": jnp.zeros((dim,), jnp.float32)}


def layer_norm(p, x, dtype=None, eps: float = 1e-6):
    """flax LayerNorm numerics: float32 statistics, output in `dtype`."""
    xf = x.astype(jnp.float32)
    m = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.maximum(jnp.mean(jnp.square(xf), axis=-1, keepdims=True) - m * m, 0.0)
    y = (xf - m) * jax.lax.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.astype(dtype or jnp.result_type(x, jnp.float32))


@dataclasses.dataclass(frozen=True)
class MLP(Module):
    """Linear→ELU(→LayerNorm) stack (networks.py:49-71)."""

    hidden_units: Sequence[int]
    layer_norm: bool = True
    dtype: Any = None

    def params(self, key, x):
        p, in_dim = {}, x.shape[-1]
        for i, (units, k) in enumerate(
            zip(self.hidden_units, jax.random.split(key, len(self.hidden_units)))
        ):
            p[f"Dense_{i}"] = dense_params(k, in_dim, units)
            if self.layer_norm:
                p[f"LayerNorm_{i}"] = layer_norm_params(units)
            in_dim = units
        return p

    def forward(self, p, x):
        for i in range(len(self.hidden_units)):
            x = jax.nn.elu(dense(p[f"Dense_{i}"], x, self.dtype))
            if self.layer_norm:
                x = layer_norm(p[f"LayerNorm_{i}"], x, self.dtype)
        return x


@dataclasses.dataclass(frozen=True)
class FlatEncoder(Module):
    """LayerNorm(input) → MLP — the flat-spec path of make_encoder
    (learning/common.py:88-102)."""

    hidden_units: Sequence[int] = (256, 256, 256)
    layer_norm: bool = True
    dtype: Any = None
    scope = "FlatEncoder_0"

    def _mlp(self):
        return MLP(tuple(self.hidden_units), self.layer_norm, self.dtype)

    def params(self, key, x):
        return {
            "LayerNorm_0": layer_norm_params(x.shape[-1]),
            "MLP_0": self._mlp().params(key, x),
        }

    def forward(self, p, x):
        return self._mlp().forward(p["MLP_0"], layer_norm(p["LayerNorm_0"], x, self.dtype))


def entity_group_order(keys) -> list:
    """Canonical entity-group order: the self/query group first, the rest
    sorted.

    JAX pytree round-trips (scan carries, jit boundaries, flatten/unflatten)
    rebuild dicts in sorted-key order, so relying on insertion order would
    silently move the attention query token (the reference puts `state_self`
    first per its CompositeSpec order, networks.py:250-313).  Attention and
    sum-pooling are permutation-invariant over the non-query tokens, so
    pinning "query group first, rest sorted" fixes the semantics for every
    dict ordering."""
    keys = list(keys)
    self_keys = [k for k in keys if k in ("state_self", "state_drones")]
    rest = sorted(k for k in keys if k not in ("state_self", "state_drones"))
    return self_keys + rest


@dataclasses.dataclass(frozen=True)
class PartialAttentionEncoder(Module):
    """Single-head attention with the first self-entity token as the only
    query, followed by a residual feed-forward block (networks.py:250-313).

    obs: dict of (..., k_i, d_i) entity groups → (..., embed_dim) float32.
    The math is `ops.fused_encoder._encode` over the packed rows."""

    embed_dim: int = 128
    dim_feedforward: int = 128
    dtype: Any = None
    scope = "PartialAttentionEncoder_0"

    def spec(self, obs):
        names = entity_group_order(obs.keys())
        groups = tuple((obs[n].shape[-2], obs[n].shape[-1]) for n in names)
        dtype = jnp.dtype(self.dtype or jnp.float32).name
        return EncoderSpec(groups=groups, dtype=dtype), names

    def params(self, key, obs):
        spec, names = self.spec(obs)
        e, ff = self.embed_dim, self.dim_feedforward
        ks = iter(jax.random.split(key, len(names) + 6))
        embed = {
            f"embed_{n}": dense_params(next(ks), d, e)
            for n, (_, d) in zip(names, spec.groups)
        }
        embed["LayerNorm_0"] = layer_norm_params(e)

        def proj():  # [in, heads=1, head_dim] query/key/value layout
            p = dense_params(next(ks), e, e)
            return {"kernel": p["kernel"].reshape(e, 1, e), "bias": p["bias"].reshape(1, e)}

        attn = {"query": proj(), "key": proj(), "value": proj()}
        out = dense_params(next(ks), e, e)
        attn["out"] = {"kernel": out["kernel"].reshape(1, e, e), "bias": out["bias"]}
        return {
            "SplitEmbedding_0": embed,
            "attn": attn,
            "LayerNorm_0": layer_norm_params(e),
            "Dense_0": dense_params(next(ks), e, ff),
            "Dense_1": dense_params(next(ks), ff, e),
            "LayerNorm_1": layer_norm_params(e),
        }

    def forward(self, p, obs):
        spec, names = self.spec(obs)
        x, lead = pack_obs(spec, obs, names)
        y = _encode(spec, x.astype(jnp.float32), encoder_leaves(p, names))
        return y.reshape(lead + (self.embed_dim,))


@dataclasses.dataclass(frozen=True)
class _LinenEncoder(Module):
    """A flax linen encoder behind the functional interface (its param
    subtree sits under `scope`)."""

    module: Any
    scope: str

    def params(self, key, x):
        return self.module.init(key, x)["params"]

    def forward(self, p, x):
        return self.module.apply({"params": p}, x)


def make_encoder(
    cfg_hidden_units, attn_encoder: str, obs_is_dict: bool, dtype: Any = None
) -> Module:
    """Encoder factory mirroring learning/common.py:88-142: flat specs get the
    LayerNorm+MLP, dict (composite) specs get the configured entity encoder."""
    if not obs_is_dict:
        return FlatEncoder(tuple(cfg_hidden_units), dtype=dtype)
    if attn_encoder == "PartialAttentionEncoder":
        return PartialAttentionEncoder(dtype=dtype)
    from .linen import RELATION_ENCODERS

    return _LinenEncoder(RELATION_ENCODERS[attn_encoder](dtype=dtype), f"{attn_encoder}_0")
