"""TP-net: the Evader Prediction-Enhanced Network (paper contribution #1).

LSTM(input→64) over a 10-frame masked observation history, linear head, tanh
— predicting `future_prediction_step` normalized future evader positions.
Counterpart of omni_drones/learning/mappo.py:572-589 (`TP_net`), wired into
observations at hideandseek.py:805-854.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from .modules.networks import Module, dense_params

_GATES = ("i", "f", "g", "o")


def _lstm_last_hidden(cell, xf, dtype):
    """LSTM over a short fixed window → last hidden state [B, H].

    xf: [B, T, F].  The input projections of every gate and every step are
    ONE [B·T, F] × [F, 4H] matmul; only the [B, H] × [H, 4H] recurrence is
    sequential.  Gate math of flax's OptimizedLSTMCell:
    c' = σ(f)·c + σ(i)·tanh(g), h' = σ(o)·tanh(c')."""
    b, t, f = xf.shape
    wi = jnp.concatenate([cell[f"i{g}"]["kernel"] for g in _GATES], axis=1).astype(dtype)
    wh = jnp.concatenate([cell[f"h{g}"]["kernel"] for g in _GATES], axis=1).astype(dtype)
    bh = jnp.concatenate([cell[f"h{g}"]["bias"] for g in _GATES], axis=0).astype(dtype)
    h = wh.shape[0]
    xw = (xf.reshape(b * t, f).astype(dtype) @ wi).reshape(b, t, 4 * h)
    c = jnp.zeros((b, h), dtype)
    hh = jnp.zeros((b, h), dtype)
    # unrolled python loop: T is small and static (10), which keeps a
    # nested while loop out of the enclosing rollout scan
    for step in range(t):
        gates = xw[:, step] + hh @ wh + bh
        gi = jax.nn.sigmoid(gates[:, :h])
        gf = jax.nn.sigmoid(gates[:, h : 2 * h])
        gg = jnp.tanh(gates[:, 2 * h : 3 * h])
        go = jax.nn.sigmoid(gates[:, 3 * h :])
        c = gf * c + gi * gg
        hh = go * jnp.tanh(c)
    return hh


@dataclasses.dataclass(frozen=True)
class TPNet(Module):
    """LSTM encoder over the history window → tanh-normalized predictions.

    The LSTM matmuls run in bfloat16 (params and the head stay float32):
    the supervised update processes ~240 K windows per training iteration
    and the matmul tower is its entire cost; tanh-bounded activations make
    bf16 safe here, matching the policy trunks' precision policy.

    Param tree of flax's `nn.RNN(OptimizedLSTMCell)` + Dense "fc":
    {"OptimizedLSTMCell_0": {i*: {kernel}, h*: {kernel, bias}}, "fc": ...},
    with lecun-normal input, orthogonal recurrent and zero bias inits.
    """

    output_dim: int            # 3 * future_prediction_step
    hidden_dim: int = 64
    future_prediction_step: int = 5
    window_step: int = 1
    dtype: Any = jnp.bfloat16

    def params(self, key, x):
        f, h = x.shape[-1], self.hidden_dim
        keys = iter(jax.random.split(key, 2 * len(_GATES) + 1))
        cell = {}
        for g in _GATES:
            cell[f"i{g}"] = {"kernel": jax.nn.initializers.lecun_normal()(next(keys), (f, h), jnp.float32)}
        for g in _GATES:
            cell[f"h{g}"] = {
                "kernel": jax.nn.initializers.orthogonal()(next(keys), (h, h), jnp.float32),
                "bias": jnp.zeros((h,), jnp.float32),
            }
        return {
            "OptimizedLSTMCell_0": cell,
            "fc": dense_params(next(keys), h, self.output_dim),
        }

    def forward(self, p, x):
        """x: (..., history_step, input_dim) → (..., output_dim) in (−1, 1)."""
        batch_shape = x.shape[:-2]
        xf = x.reshape((-1,) + x.shape[-2:])
        last = _lstm_last_hidden(p["OptimizedLSTMCell_0"], xf, self.dtype)
        y = jnp.dot(last.astype(jnp.float32), p["fc"]["kernel"]) + p["fc"]["bias"]
        return jnp.tanh(y).reshape(batch_shape + (self.output_dim,))


def denormalize_predictions(
    pred: jnp.ndarray, arena_size: float, max_height: float
) -> jnp.ndarray:
    """Map tanh outputs to arena coordinates (hideandseek.py:835-836):
    x, y ∈ [−arena/2·… scaled by 0.5·arena], z ∈ [0, max_height]."""
    xy = pred[..., :2] * 0.5 * arena_size
    z = (pred[..., 2:3] + 1.0) / 2.0 * max_height
    return jnp.concatenate([xy, z], axis=-1)


def normalize_groundtruth(
    pos: jnp.ndarray, arena_size: float, max_height: float
) -> jnp.ndarray:
    """Inverse mapping for supervision targets (hideandseek.py:840-842)."""
    xy = pos[..., :2] / (0.5 * arena_size)
    z = pos[..., 2:3] / max_height * 2.0 - 1.0
    return jnp.concatenate([xy, z], axis=-1)
