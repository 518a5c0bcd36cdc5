"""PartialAttentionEncoder + linear head on packed observation rows, in jnp.

The MAPPO update's hot op is fwd+bwd of a tiny entity-attention encoder
(reference networks.py:250-313 + head) over ~50k samples per minibatch,
128 times per training iteration.  This module holds that network as one
straight-line function over a canonical tuple of parameter leaves, so the
update can run actor and critic over the same packed minibatch rows
(`reference_apply`) and `jax.grad` flows into the param tree through
`extract_leaves`.  The functional `PartialAttentionEncoder`
(learning/modules/networks.py) runs the same `_encode`.

Numerics: matmuls in `EncoderSpec.dtype` (bfloat16 by default) with float32
accumulation, LayerNorm statistics and softmax in float32, tanh-approximate
GELU, float32 head.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

import jax
import jax.numpy as jnp

_LN_EPS = 1e-6  # flax LayerNorm default


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    """Static description of the encoder's input and precision.

    groups: per entity group (in canonical order) the (num_tokens, feat_dim).
    dtype: matmul operand dtype of the trunk (name, e.g. "bfloat16").
    """

    groups: Tuple[Tuple[int, int], ...]
    dtype: str = "bfloat16"


# ---------------------------------------------------------------- param I/O
def encoder_leaves(enc, group_names: Sequence[str]) -> tuple:
    """Encoder subtree (flax layout) → canonical flat tuple of leaves.

    Layout: per-group (Wg, bg)…, ln0(scale, bias), Wq, bq, Wk, bk, Wv, bv,
    Wo, bo, ln1(scale, bias), W1, b1, W2, b2, ln2(scale, bias).
    Attention kernels are reshaped from the [in, heads, head] layout.
    """
    se = enc["SplitEmbedding_0"]
    attn = enc["attn"]
    e = attn["out"]["bias"].shape[-1]
    leaves = []
    for name in group_names:
        leaves += [se[f"embed_{name}"]["kernel"], se[f"embed_{name}"]["bias"]]
    leaves += [se["LayerNorm_0"]["scale"], se["LayerNorm_0"]["bias"]]
    leaves += [
        attn["query"]["kernel"].reshape(e, e), attn["query"]["bias"].reshape(e),
        attn["key"]["kernel"].reshape(e, e), attn["key"]["bias"].reshape(e),
        attn["value"]["kernel"].reshape(e, e), attn["value"]["bias"].reshape(e),
        attn["out"]["kernel"].reshape(e, e), attn["out"]["bias"],
    ]
    leaves += [enc["LayerNorm_0"]["scale"], enc["LayerNorm_0"]["bias"]]
    leaves += [enc["Dense_0"]["kernel"], enc["Dense_0"]["bias"]]
    leaves += [enc["Dense_1"]["kernel"], enc["Dense_1"]["bias"]]
    leaves += [enc["LayerNorm_1"]["scale"], enc["LayerNorm_1"]["bias"]]
    return tuple(leaves)


def extract_leaves(params, group_names: Sequence[str]):
    """Actor/critic param tree → encoder leaves + (Wh, bh) of the head
    (actor: DiagGaussianHead_0/Dense_0, critic: top-level Dense_0)."""
    p = params["params"]
    enc_key = next(k for k in p if k.startswith("PartialAttentionEncoder"))
    if "DiagGaussianHead_0" in p:
        head = p["DiagGaussianHead_0"]["Dense_0"]
    else:
        head = p["Dense_0"]
    return encoder_leaves(p[enc_key], group_names) + (
        head["kernel"], head["bias"]
    )


def pack_obs(spec: EncoderSpec, obs: Dict[str, jnp.ndarray], group_names):
    """Dict of [..., k, d] groups → [S, obs_dim] rows in canonical order."""
    lead = obs[group_names[0]].shape[:-2]
    parts = [
        obs[name].reshape(lead + (-1,)).reshape((-1, k * d))
        for name, (k, d) in zip(group_names, spec.groups)
    ]
    return jnp.concatenate(parts, axis=-1), lead


# ---------------------------------------------------------------- math core
def _ln_f32(x, scale, bias):
    x = x.astype(jnp.float32)
    m = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.maximum(jnp.mean(jnp.square(x), axis=-1, keepdims=True) - m * m, 0.0)
    return (x - m) * jax.lax.rsqrt(var + _LN_EPS) * scale + bias


def _gelu_tanh(x):
    # flax nn.gelu(approximate=True)
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + jnp.tanh(c * (x + 0.044715 * x * x * x)))


def _encode(spec: EncoderSpec, x, leaves):
    """[T, obs_dim] rows → [T, embed_dim] float32 encoder features.

    Per-group token embeds, LayerNorm over all tokens, single-head attention
    with the first token as the only query, then the post-norm residual
    feed-forward block (networks.py:250-313, norm_first=False)."""
    it = iter(leaves)
    gw = [(next(it), next(it)) for _ in spec.groups]
    g0, b0 = next(it), next(it)
    wq, bq, wk, bk, wv, bv, wo, bo = (next(it) for _ in range(8))
    g1, b1, w1, bf1, w2, bf2, g2, b2 = (next(it) for _ in range(8))
    dt = jnp.dtype(spec.dtype)

    def mm(a, b):
        return jnp.dot(a.astype(dt), b.astype(dt), preferred_element_type=jnp.float32)

    t_rows = x.shape[0]
    embeds, off = [], 0
    for (k, d), (wg, bg) in zip(spec.groups, gw):
        xg = x[:, off : off + k * d].reshape(t_rows, k, d)
        embeds.append((mm(xg, wg) + bg).astype(dt))
        off += k * d
    h = _ln_f32(jnp.concatenate(embeds, axis=1), g0, b0)    # [T, n_tok, E]
    q = mm(h[:, 0], wq) + bq                                # [T, E]
    ks = (mm(h, wk) + bk).astype(dt).astype(jnp.float32)   # [T, n_tok, E]
    vs = (mm(h, wv) + bv).astype(dt).astype(jnp.float32)
    # scores and the weighted sum are elementwise products + reductions,
    # so they stay in float32 on every backend
    scores = jnp.sum(q[:, None, :] * ks, axis=-1) / math.sqrt(q.shape[-1])
    att = jnp.sum(jax.nn.softmax(scores, axis=-1)[..., None] * vs, axis=1)
    y1 = _ln_f32(h[:, 0] + mm(att, wo) + bo, g1, b1)
    f = _gelu_tanh(mm(y1, w1) + bf1)
    return _ln_f32(y1 + mm(f, w2) + bf2, g2, b2)


def _forward_core(spec: EncoderSpec, x, leaves):
    """Encoder + float32 linear head: [T, obs_dim] → [T, head_dim]."""
    *enc, wh, bh = leaves
    return jnp.dot(_encode(spec, x, enc), wh) + bh


def reference_apply(spec: EncoderSpec, leaves, obs_packed):
    """[S, obs_dim] → [S, head_dim] through the encoder+head."""
    return _forward_core(spec, obs_packed.astype(jnp.float32), leaves)

