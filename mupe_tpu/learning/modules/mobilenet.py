"""MobileNetV3 feature backbones in flax — the reference's vision branch.

JAX counterpart of `MobileNetV3Small`/`MobilNetV3Large`
(omni_drones/learning/modules/networks.py:371-428), which wrap torchvision's
pretrained backbone with `track_running_stats=False` (i.e. BatchNorm always
normalizes by the CURRENT batch statistics — no running averages).  Here the
architecture is implemented directly (Howard et al. 2019, table 1/2):

- NHWC layout (channels-last), bf16-friendly: convs run in the module
  dtype with f32 norm statistics;
- `_BatchStatsNorm` reproduces track_running_stats=False exactly: learned
  scale/bias, normalization by per-batch statistics, NO mutable state — the
  whole network stays a pure function (jit/scan/vmap-safe, unlike flax's
  stateful BatchNorm);
- squeeze-excite with hard-sigmoid gates and hard-swish activations as in
  torchvision.

No pretrained weights: this image has no egress and no torchvision, so the
backbone trains from scratch (fine for the paper's use — vision is viz-only;
the encoder row is here for API parity and for users who train vision
policies end-to-end).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import jax.numpy as jnp
from flax import linen as nn


def _hard_sigmoid(x):
    return jnp.clip(x / 6.0 + 0.5, 0.0, 1.0)


def _hard_swish(x):
    return x * _hard_sigmoid(x)


def _make_divisible(v: float, divisor: int = 8) -> int:
    """torchvision channel rounding (all widths multiples of 8)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class _BatchStatsNorm(nn.Module):
    """BatchNorm with track_running_stats=False semantics: normalize by the
    statistics of the current batch (over N, H, W), learned scale/bias,
    no state.  Statistics in float32 regardless of compute dtype."""

    eps: float = 1e-3  # torchvision MobileNetV3 BN eps

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        c = x.shape[-1]
        scale = self.param("scale", nn.initializers.ones, (c,))
        bias = self.param("bias", nn.initializers.zeros, (c,))
        xf = x.astype(jnp.float32)
        mean = jnp.mean(xf, axis=tuple(range(xf.ndim - 1)))
        var = jnp.var(xf, axis=tuple(range(xf.ndim - 1)))
        y = (xf - mean) / jnp.sqrt(var + self.eps)
        return (y * scale + bias).astype(x.dtype)


class _SqueezeExcite(nn.Module):
    """SE block: GAP → FC(exp/4, relu) → FC(exp, hard-sigmoid) gate."""

    channels: int
    dtype: Any = None

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        squeeze = _make_divisible(self.channels / 4)
        s = jnp.mean(x.astype(jnp.float32), axis=(-3, -2))  # [N, C]
        s = nn.Dense(squeeze, dtype=self.dtype)(s.astype(x.dtype))
        s = nn.relu(s)
        s = nn.Dense(self.channels, dtype=self.dtype)(s)
        gate = _hard_sigmoid(s.astype(jnp.float32)).astype(x.dtype)
        return x * gate[..., None, None, :]


@dataclasses.dataclass(frozen=True)
class _BneckCfg:
    kernel: int
    exp: int
    out: int
    se: bool
    hs: bool      # hard-swish (else relu)
    stride: int


class _InvertedResidual(nn.Module):
    cfg: _BneckCfg
    dtype: Any = None

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        c = self.cfg
        act = _hard_swish if c.hs else nn.relu
        inp = x.shape[-1]
        h = x
        if c.exp != inp:
            h = nn.Conv(c.exp, (1, 1), use_bias=False, dtype=self.dtype)(h)
            h = _BatchStatsNorm()(h)
            h = act(h)
        # depthwise
        h = nn.Conv(
            c.exp, (c.kernel, c.kernel), strides=(c.stride, c.stride),
            padding="SAME", feature_group_count=c.exp, use_bias=False,
            dtype=self.dtype,
        )(h)
        h = _BatchStatsNorm()(h)
        h = act(h)
        if c.se:
            h = _SqueezeExcite(channels=c.exp, dtype=self.dtype)(h)
        h = nn.Conv(c.out, (1, 1), use_bias=False, dtype=self.dtype)(h)
        h = _BatchStatsNorm()(h)
        if c.stride == 1 and inp == c.out:
            h = h + x
        return h


_SMALL = (
    _BneckCfg(3, 16, 16, True, False, 2),
    _BneckCfg(3, 72, 24, False, False, 2),
    _BneckCfg(3, 88, 24, False, False, 1),
    _BneckCfg(5, 96, 40, True, True, 2),
    _BneckCfg(5, 240, 40, True, True, 1),
    _BneckCfg(5, 240, 40, True, True, 1),
    _BneckCfg(5, 120, 48, True, True, 1),
    _BneckCfg(5, 144, 48, True, True, 1),
    _BneckCfg(5, 288, 96, True, True, 2),
    _BneckCfg(5, 576, 96, True, True, 1),
    _BneckCfg(5, 576, 96, True, True, 1),
)

_LARGE = (
    _BneckCfg(3, 16, 16, False, False, 1),
    _BneckCfg(3, 64, 24, False, False, 2),
    _BneckCfg(3, 72, 24, False, False, 1),
    _BneckCfg(5, 72, 40, True, False, 2),
    _BneckCfg(5, 120, 40, True, False, 1),
    _BneckCfg(5, 120, 40, True, False, 1),
    _BneckCfg(3, 240, 80, False, True, 2),
    _BneckCfg(3, 200, 80, False, True, 1),
    _BneckCfg(3, 184, 80, False, True, 1),
    _BneckCfg(3, 184, 80, False, True, 1),
    _BneckCfg(3, 480, 112, True, True, 1),
    _BneckCfg(3, 672, 112, True, True, 1),
    _BneckCfg(5, 672, 160, True, True, 2),
    _BneckCfg(5, 960, 160, True, True, 1),
    _BneckCfg(5, 960, 160, True, True, 1),
)


class MobileNetV3(nn.Module):
    """features + avgpool + flatten, as the reference backbone slices it.

    Input (..., H, W, C) with C ∈ {1, 3}; 1-channel inputs are repeated to
    3 like the reference forward (networks.py:404-407).  Output feature
    dim: 576 (small) / 960 (large)."""

    variant: str = "small"       # "small" | "large"
    dtype: Any = None

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        blocks = _SMALL if self.variant == "small" else _LARGE
        last_exp = 576 if self.variant == "small" else 960
        batch_shape = x.shape[:-3]
        h = x.reshape((-1,) + x.shape[-3:]).astype(
            self.dtype or jnp.float32
        )
        if h.shape[-1] == 1:
            h = jnp.repeat(h, 3, axis=-1)
        assert h.shape[-1] == 3, f"C must be 1 or 3, got {h.shape[-1]}"
        h = nn.Conv(
            16, (3, 3), strides=(2, 2), padding="SAME", use_bias=False,
            dtype=self.dtype,
        )(h)
        h = _BatchStatsNorm()(h)
        h = _hard_swish(h)
        for i, bc in enumerate(blocks):
            h = _InvertedResidual(cfg=bc, dtype=self.dtype, name=f"bneck_{i}")(h)
        h = nn.Conv(last_exp, (1, 1), use_bias=False, dtype=self.dtype)(h)
        h = _BatchStatsNorm()(h)
        h = _hard_swish(h)
        h = jnp.mean(h.astype(jnp.float32), axis=(-3, -2))  # avgpool
        return h.reshape(batch_shape + (last_exp,))
