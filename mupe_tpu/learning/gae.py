"""Generalized Advantage Estimation as a parallel prefix scan.

Counterpart of omni_drones/learning/utils/gae.py:27-74 — identical
recursion.  GAE is a first-order linear recurrence
(gae_t = δ_t + γλ·nd_t · gae_{t+1}), so instead of T sequential steps it
runs as `lax.associative_scan` over the affine maps (c, d) ↦ c·y + d —
log₂(T) fused passes (the time axis is only 64 but each sequential step
is a tiny kernel; the scan form removes the 64-deep dependency chain from
the update program's critical path).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def compute_gae(
    reward: jnp.ndarray,      # [T, N, k]
    done: jnp.ndarray,        # [T, N, 1] (or [T, N, k])
    value: jnp.ndarray,       # [T, N, k]
    next_value: jnp.ndarray,  # [N, k] — V(s_T)
    gamma: float = 0.99,
    lmbda: float = 0.95,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Time-major GAE (gae.py:54-74 `compute_gae_`).

    Returns (advantages, returns) with returns = advantages + value.
    """
    not_done = 1.0 - done.astype(reward.dtype)
    nd = jnp.broadcast_to(not_done, reward.shape)
    v_next = jnp.concatenate([value[1:], next_value[None]], axis=0)
    delta = reward + gamma * v_next * nd - value
    coef = gamma * lmbda * nd

    def combine(prev, cur):
        # affine-map composition: y_i = c_i·y_{i-1} + d_i
        c_p, d_p = prev
        c_c, d_c = cur
        return c_c * c_p, c_c * d_p + d_c

    # reverse-time recurrence: scan over the reversed axis
    _, adv_rev = jax.lax.associative_scan(
        combine, (coef[::-1], delta[::-1]), axis=0
    )
    advantages = adv_rev[::-1]
    return advantages, advantages + value


def compute_gae_scan(
    reward: jnp.ndarray,
    done: jnp.ndarray,
    value: jnp.ndarray,
    next_value: jnp.ndarray,
    gamma: float = 0.99,
    lmbda: float = 0.95,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Sequential `lax.scan` reference implementation (golden model for
    the associative form; identical recursion to the reference loop)."""
    not_done = 1.0 - done.astype(reward.dtype)

    def body(carry, inp):
        gae, nxt_value = carry
        r, nd, v = inp
        delta = r + gamma * nxt_value * nd - v
        gae = delta + gamma * lmbda * nd * gae
        return (gae, v), gae

    (_, _), adv_rev = jax.lax.scan(
        body,
        (jnp.zeros_like(next_value), next_value),
        (reward[::-1], not_done[::-1], value[::-1]),
    )
    advantages = adv_rev[::-1]
    return advantages, advantages + value
