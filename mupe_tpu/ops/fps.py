"""Farthest-point sampling, jittable.

Plain-JAX replacement for the one third-party native *algorithm* the
reference depends on: DGL's CUDA `farthest_point_sampler`
(dgl.geometry, used by GenBuffer.insert_history,
omni_drones/envs/hide_and_seek/hideandseek_envgen.py:44,301).

Iterative max-min selection: keep a running min-distance-to-selected vector
and greedily take the farthest point, as a `lax.fori_loop` of fused vector
ops — O(K·N·D) with no host round-trips.  Matches DGL's semantics (start
index 0, squared-Euclidean metric).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def farthest_point_sampling(
    points: jnp.ndarray,     # [N, D]
    k: int,
    valid: jnp.ndarray | None = None,  # [N] bool — candidates mask
    start_index: int = 0,
) -> jnp.ndarray:
    """Indices [k] of a farthest-point subset of `points`.

    Invalid points are never selected (their distance contribution is −inf);
    if fewer than k valid points exist, selections repeat the farthest ones.
    """
    n = points.shape[0]
    if valid is None:
        valid = jnp.ones((n,), bool)
    neg_inf = jnp.asarray(-jnp.inf, points.dtype)

    def dist_to(i):
        return jnp.sum(jnp.square(points - points[i]), axis=-1)

    init_idx = jnp.asarray(start_index, jnp.int32)
    min_dist = jnp.where(valid, dist_to(init_idx), neg_inf)
    selected = jnp.zeros((k,), jnp.int32).at[0].set(init_idx)

    def body(i, carry):
        selected, min_dist = carry
        nxt = jnp.argmax(min_dist).astype(jnp.int32)
        selected = selected.at[i].set(nxt)
        d = jnp.where(valid, dist_to(nxt), neg_inf)
        min_dist = jnp.minimum(min_dist, d)
        return selected, min_dist

    selected, _ = jax.lax.fori_loop(1, k, body, (selected, min_dist))
    return selected

