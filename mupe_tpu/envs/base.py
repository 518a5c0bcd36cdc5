"""Environment core: pure reset/step functions over explicit state pytrees.

JAX replacement for the reference's ``IsaacEnv`` torchrl base
(omni_drones/envs/isaac_env.py:47-389).  Key differences, by design:

- No simulator process, no views layer: the physics state *is* the env state
  (a pytree), stepped by `mupe_tpu.dynamics` inside the same jitted program.
- Env replication (GridCloner, isaac_env.py:98-140) is just a leading batch
  axis, shardable across a device mesh.
- Auto-reset happens inside `step` via `jnp.where` selects, preserving the
  reference semantics that the stats reported at `done` are the finished
  episode's (isaac_env.py:216-223).
- All per-episode Python-side state of the reference (stats dicts, PID
  integrators, obs history deques) lives in the state pytree.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import jax
import jax.numpy as jnp

from ..core import struct


@struct.dataclass
class Transition:
    """One vectorized env transition, the unit collected by rollouts.

    ``obs`` is the observation *after* this step (and after any auto-reset),
    i.e. the next policy input.  ``stats`` is the env's stats channel
    snapshot taken when the step completed (episode-normalized at done, like
    hideandseek.py:1017-1056); consume it where ``done`` is set.
    """

    obs: Any
    reward: jnp.ndarray
    done: jnp.ndarray
    stats: Dict[str, jnp.ndarray]
    info: Dict[str, jnp.ndarray]


def where_done(done: jnp.ndarray, reset_val: Any, old_val: Any) -> Any:
    """Pytree select: take `reset_val` where done else `old_val`.

    `done` has shape [num_envs]; leaves may have any trailing dims.
    """

    def sel(a, b):
        d = done.reshape(done.shape + (1,) * (a.ndim - done.ndim))
        return jnp.where(d, a, b)

    return jax.tree_util.tree_map(sel, reset_val, old_val)


ENV_REGISTRY: Dict[str, Callable] = {}


def register_env(name: str):
    """Subclass registry, mirroring IsaacEnv.REGISTRY (isaac_env.py:154-161)."""

    def deco(cls):
        ENV_REGISTRY[name] = cls
        ENV_REGISTRY[name.lower()] = cls
        return cls

    return deco


def time_encoding(progress: jnp.ndarray, max_len: int, dim: int = 4) -> jnp.ndarray:
    """The reference's time encoding: t/T broadcast to `dim` channels
    (hideandseek.py:796,852)."""
    t = (progress / max_len)[..., None]
    return jnp.broadcast_to(t, progress.shape + (dim,))


def zeros_stats(keys: Tuple[str, ...], num_envs: int, dtype=jnp.float32):
    return {k: jnp.zeros((num_envs, 1), dtype) for k in keys}
