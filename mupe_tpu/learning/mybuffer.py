"""Trajectory ring buffer — JAX counterpart of the reference's
`MyBuffer` (omni_drones/learning/common.py:42-81).

The reference wraps torchrl's LazyTensorStorage: `extend` writes T new
time steps (time-major) into a ring over the time axis, `sample` draws
random envs and random CONTIGUOUS sub-trajectories of a fixed length.
Here the storage is a fixed-capacity pytree (leaves [L, E, ...]), the
state is an immutable struct, and both operations are statically-shaped
pure functions — usable inside jit/scan (the reference's is host-side
Python; it is unused by the paper's main path but part of the library
surface)."""
from __future__ import annotations

from typing import Any, Tuple

import jax
import jax.numpy as jnp

from ..core import struct


@struct.dataclass
class TrajRingBuffer:
    """Ring over the TIME axis; leaves are [capacity, E, ...]."""

    storage: Any
    cursor: jnp.ndarray   # [] int32 — next write row
    length: jnp.ndarray   # [] int32 — valid rows (≤ capacity)

    @property
    def capacity(self) -> int:
        return jax.tree_util.tree_leaves(self.storage)[0].shape[0]

    @classmethod
    def create(cls, example, capacity: int) -> "TrajRingBuffer":
        """`example` is one time slice (pytree; leaves [E, ...])."""
        storage = jax.tree_util.tree_map(
            lambda x: jnp.zeros((capacity,) + x.shape, x.dtype), example
        )
        return cls(
            storage=storage,
            cursor=jnp.zeros((), jnp.int32),
            length=jnp.zeros((), jnp.int32),
        )


def extend(buf: TrajRingBuffer, data) -> TrajRingBuffer:
    """Append a time-major chunk (leaves [T, E, ...]) at the cursor,
    wrapping (common.py:52-57)."""
    t = jax.tree_util.tree_leaves(data)[0].shape[0]
    cap = buf.capacity
    rows = (buf.cursor + jnp.arange(t)) % cap
    storage = jax.tree_util.tree_map(
        lambda s, d: s.at[rows].set(d), buf.storage, data
    )
    return buf.replace(
        storage=storage,
        cursor=(buf.cursor + t) % cap,
        length=jnp.minimum(buf.length + t, cap),
    )


def sample(
    buf: TrajRingBuffer, key: jnp.ndarray, batch_size: int, seq_len: int
) -> Tuple[Any, jnp.ndarray]:
    """Random (env, contiguous window) sub-trajectories: leaves
    [batch_size, seq_len, ...] (common.py:59-81 `sample` +
    `sample_sub_traj`).  Returns (batch, valid_mask [batch_size]) — the
    mask flags samples drawn while the buffer held < seq_len rows (the
    reference raises; a static-shape program can't, so it masks)."""
    e = jax.tree_util.tree_leaves(buf.storage)[0].shape[1]
    cap = buf.capacity
    k_env, k_t = jax.random.split(key)
    env_idx = jax.random.randint(k_env, (batch_size,), 0, e)
    max_start = jnp.maximum(buf.length - seq_len, 0)
    t0 = jax.random.randint(k_t, (batch_size,), 0, jnp.maximum(max_start, 1))
    # chronological → storage coordinates: the oldest valid row sits at
    # (cursor - length) mod cap, so windows are contiguous in TIME and
    # never stitch the newest write onto the oldest row across the ring
    # seam (they may wrap in storage coordinates, which is harmless)
    oldest = (buf.cursor - buf.length) % cap
    rows = (oldest + t0[:, None] + jnp.arange(seq_len)[None, :]) % cap  # [B, S]
    batch = jax.tree_util.tree_map(
        lambda s: s[rows, env_idx[:, None]], buf.storage
    )
    valid = jnp.broadcast_to(buf.length >= seq_len, (batch_size,))
    return batch, valid


def size(buf: TrajRingBuffer) -> jnp.ndarray:
    """len(buffer) (common.py:75-76)."""
    return buf.length
