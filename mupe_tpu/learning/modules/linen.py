"""Flax linen modules of the algorithms that are not yet functional.

The MAPPO main path (HideAndSeek, AEG, Hover) runs on the plain-JAX modules
of `networks.py`, `distributions.py` and `tp_net.py`.  The PPO variant
family (learning/ppo/*), the vision policy (`ppo_vision`) and MAPPO's
relation encoders (`algo.attn_encoder=RelationEncoder`) still build on the
linen modules below, so flax is imported only when one of them is chosen.

Counterparts of omni_drones/learning/modules/networks.py: `MLP` (:49-71),
`SplitEmbedding` (:125-163), `RelationEncoder` (:171-206),
`PartialRelationEncoder` (:210-246), `LFF` (:88-122), `MixedEncoder`
(:322-368), and of distributions.py `DiagGaussian` (:66-82).
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import jax.numpy as jnp
from flax import linen as nn

from .distributions import Gaussian
from .networks import entity_group_order


class MLP(nn.Module):
    """Linear→activation(→LayerNorm) stack (networks.py:49-71)."""

    hidden_units: Sequence[int]
    layer_norm: bool = True
    dtype: Any = None

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        for units in self.hidden_units:
            x = nn.Dense(units, dtype=self.dtype)(x)
            x = nn.elu(x)
            if self.layer_norm:
                x = nn.LayerNorm(dtype=self.dtype)(x)
        return x


class DiagGaussianHead(nn.Module):
    """Linear mean + state-independent log-std (distributions.py:66-82).

    Mean weights initialized xavier-uniform with gain 0.01, zero bias,
    log_std starts at 0 — matching the reference's `init_` + zeros.
    """

    action_dim: int
    gain: float = 0.01

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> Gaussian:
        mean = nn.Dense(
            self.action_dim,
            kernel_init=nn.initializers.variance_scaling(
                # xavier_uniform with gain g ⇒ scale = g² · (fan_avg variance 1)
                self.gain**2, "fan_avg", "uniform"
            ),
            bias_init=nn.initializers.zeros,
        )(x)
        log_std = self.param(
            "log_std", nn.initializers.zeros, (self.action_dim,)
        )
        return Gaussian(mean=mean, log_std=jnp.broadcast_to(log_std, mean.shape))


class SplitEmbedding(nn.Module):
    """Per-key linear embedding of entity groups, concatenated along the
    entity axis and LayerNormed (networks.py:125-163)."""

    embed_dim: int = 128
    layer_norm: bool = True
    dtype: Any = None

    @nn.compact
    def __call__(self, obs: Dict[str, jnp.ndarray]) -> jnp.ndarray:
        embeds = [
            nn.Dense(self.embed_dim, name=f"embed_{key}", dtype=self.dtype)(
                obs[key]
            )
            for key in entity_group_order(obs.keys())
        ]
        x = jnp.concatenate(embeds, axis=-2)
        if self.layer_norm:
            x = nn.LayerNorm(dtype=self.dtype)(x)
        return x


class RelationEncoder(nn.Module):
    """f(Σ_ij g(a_i ⊕ a_j)) over all entity pairs (networks.py:171-206)."""

    embed_dim: int = 72
    f_units: Sequence[int] = (256, 128)
    dtype: Any = None

    @nn.compact
    def __call__(self, obs: Dict[str, jnp.ndarray]) -> jnp.ndarray:
        a = SplitEmbedding(self.embed_dim, dtype=self.dtype)(obs)
        ai = jnp.repeat(a[..., :, None, :], a.shape[-2], axis=-2)
        aj = jnp.swapaxes(ai, -2, -3)
        aij = jnp.concatenate([ai, aj], axis=-1)
        g = MLP((self.f_units[0],), dtype=self.dtype)(aij)
        g = nn.LayerNorm(dtype=self.dtype)(g)
        pooled = jnp.sum(g, axis=(-3, -2))
        return MLP(tuple(self.f_units), dtype=self.dtype)(pooled)


class PartialRelationEncoder(nn.Module):
    """f(Σ_j g(a_0 ⊕ a_j)), j ≠ 0 (networks.py:210-246)."""

    embed_dim: int = 72
    f_units: Sequence[int] = (256, 128)
    dtype: Any = None

    @nn.compact
    def __call__(self, obs: Dict[str, jnp.ndarray]) -> jnp.ndarray:
        a = SplitEmbedding(self.embed_dim, dtype=self.dtype)(obs)
        ai, aj = a[..., :1, :], a[..., 1:, :]
        aij = jnp.concatenate(
            [jnp.broadcast_to(ai, aj.shape[:-1] + (ai.shape[-1],)), aj], axis=-1
        )
        g = MLP((self.f_units[0],), dtype=self.dtype)(aij)
        g = nn.LayerNorm(dtype=self.dtype)(g)
        pooled = jnp.sum(g, axis=-2)
        return MLP(tuple(self.f_units), dtype=self.dtype)(pooled)


class LFF(nn.Module):
    """Learnable Fourier features (networks.py:88-122)."""

    fourier_dim: int = 256
    embed_dim: int = 72
    sigma: float = 0.01
    cat_input: bool = True

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        b = self.param(
            "B",
            lambda key, shape: self.sigma * jnp.ones(shape) * 0
            + self.sigma * nn.initializers.normal(1.0)(key, shape),
            (x.shape[-1], self.fourier_dim),
        )
        proj = (x @ b) * (2.0 * jnp.pi)
        feats = [jnp.sin(proj), jnp.cos(proj)] + ([x] if self.cat_input else [])
        return nn.Dense(self.embed_dim)(jnp.concatenate(feats, axis=-1))


RELATION_ENCODERS = {
    "RelationEncoder": RelationEncoder,
    "PartialRelationEncoder": PartialRelationEncoder,
}


class ConvVisionEncoder(nn.Module):
    """Compact conv encoder for depth/rgb frames.

    Stands in for the reference's torchvision MobileNetV3-Small branch
    (networks.py:371-428) — vision is viz-only in the paper's tasks, so a
    small strided CNN (dense convs, static shapes) is the default; the full
    MobileNet port is `mobilenet_v3_small`/`_large`.
    """

    out_dim: int = 128

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        # x: (..., H, W, C)
        batch_shape = x.shape[:-3]
        h = x.reshape((-1,) + x.shape[-3:])
        for feat in (16, 32, 64):
            h = nn.Conv(feat, (3, 3), strides=(2, 2))(h)
            h = nn.relu(h)
        h = jnp.mean(h, axis=(-3, -2))  # global average pool
        h = nn.Dense(self.out_dim)(h)
        return h.reshape(batch_shape + (self.out_dim,))


# vision backbone registry (reference VISION_ENCODER_MAP, networks.py:369)
def make_vision_encoder(kind: str, name: str) -> nn.Module:
    if kind == "conv":
        return ConvVisionEncoder(name=name)
    if kind in ("mobilenet_v3_small", "mobilenet_v3_large"):
        from .mobilenet import MobileNetV3

        return MobileNetV3(
            variant=kind.rsplit("_", 1)[1], name=name
        )
    raise ValueError(f"unknown vision encoder {kind!r}")


class VisionActor(nn.Module):
    """Mixed vision+state actor (MixedEncoder → DiagGaussian head): the
    `ppo_vision` policy over envs emitting a "depth" frame alongside the
    flat "observation" (reference MixedEncoder, networks.py:322-368, which
    the paper never trains — here wired end-to-end as a parity-plus)."""

    action_dim: int
    vision_keys: Sequence[str] = ("depth",)
    vision_encoder: str = "conv"

    @nn.compact
    def __call__(self, obs: Dict[str, jnp.ndarray]):
        feats = MixedObsEncoder(
            vision_keys=tuple(self.vision_keys),
            vision_encoder=self.vision_encoder,
        )(obs)
        return DiagGaussianHead(self.action_dim)(feats.astype(jnp.float32))


class VisionCritic(nn.Module):
    """Mixed vision+state critic (MixedEncoder → value head)."""

    vision_keys: Sequence[str] = ("depth",)
    vision_encoder: str = "conv"
    out_dim: int = 1

    @nn.compact
    def __call__(self, obs: Dict[str, jnp.ndarray]) -> jnp.ndarray:
        feats = MixedObsEncoder(
            vision_keys=tuple(self.vision_keys),
            vision_encoder=self.vision_encoder,
        )(obs)
        return nn.Dense(
            self.out_dim, kernel_init=nn.initializers.orthogonal(0.01)
        )(feats.astype(jnp.float32))


class MixedObsEncoder(nn.Module):
    """Vision branch + state branch, concatenated then projected
    (MixedEncoder, networks.py:322-368).  `vision_encoder` selects the
    backbone: "conv" (compact CNN) or "mobilenet_v3_small"/"_large"
    (the reference's torchvision backbone, re-implemented in
    modules/mobilenet.py)."""

    vision_keys: Sequence[str]
    vision_encoder: str = "conv"
    state_hidden: Sequence[int] = (256, 256)
    out_dim: int = 256

    @nn.compact
    def __call__(self, obs: Dict[str, jnp.ndarray]) -> jnp.ndarray:
        feats = []
        for key in obs.keys():
            if key in self.vision_keys:
                feats.append(
                    make_vision_encoder(
                        self.vision_encoder, name=f"vision_{key}"
                    )(obs[key])
                )
            else:
                feats.append(MLP(tuple(self.state_hidden))(obs[key]))
        x = jnp.concatenate(feats, axis=-1)
        return MLP((self.out_dim,))(x)
