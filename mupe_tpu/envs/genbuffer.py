"""Adaptive Environment Generator (AEG) task buffer — on device.

JAX re-design of the reference `GenBuffer`
(omni_drones/envs/hide_and_seek/hideandseek_envgen.py:209-377): a particle
buffer of tasks of intermediate difficulty.  The reference keeps Python
lists / numpy arrays on the host and calls DGL's CUDA FPS; here every buffer
is a fixed-capacity array with a valid count, every operation is a masked
tensor op, and the whole AEG cycle lives inside the jitted env step.

A *task* is the flat vector
    [drone_pos (n·3), target_pos (3), cylinder_pos (C·3)]
(task_dim = 3n + 3 + 3C; hideandseek_envgen.py:212 with C=5 ⇒ 18 + 3n).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import struct
from ..ops.fps import farthest_point_sampling
from .placement import (
    Grid,
    continuous_to_grid,
    feasible_layout,
    outside_circle_mask,
)


@struct.dataclass
class GenBufferState:
    """All AEG state as fixed-shape arrays."""

    history: jnp.ndarray        # [L, task_dim] FPS-curated tasks
    history_len: jnp.ndarray    # [] int32 — valid prefix length
    eval_tasks: jnp.ndarray     # [E, task_dim] tasks under evaluation
    weight_sum: jnp.ndarray     # [E] accumulated success over eval episodes
    weight_count: jnp.ndarray   # [] int32 — episodes accumulated
    update_iter: jnp.ndarray    # [] int32 — episode counter mod eval_iter
    ratio_unif: jnp.ndarray     # [] float — uniform-sampling mix ratio
    # consecutive cycles with num_added == 0 (starvation detector — once
    # on-policy success sinks below r_min, update_history ingests nothing
    # and the curriculum stalls; observed in the r3 1.07B-frame extension)
    dry_cycles: jnp.ndarray = None

    @classmethod
    def create(
        cls, buffer_length: int, num_envs: int, task_dim: int, ratio_unif: float
    ) -> "GenBufferState":
        return cls(
            history=jnp.zeros((buffer_length, task_dim)),
            history_len=jnp.zeros((), jnp.int32),
            eval_tasks=jnp.zeros((num_envs, task_dim)),
            weight_sum=jnp.zeros((num_envs,)),
            weight_count=jnp.zeros((), jnp.int32),
            update_iter=jnp.zeros((), jnp.int32),
            ratio_unif=jnp.asarray(ratio_unif, jnp.float32),
            dry_cycles=jnp.zeros((), jnp.int32),
        )


def sample_history(
    key: jnp.ndarray, gb: GenBufferState, num: int
) -> jnp.ndarray:
    """Uniformly sample `num` tasks (with replacement) from the valid prefix
    (hideandseek_envgen.py:372-374)."""
    idx = jax.random.randint(
        key, (num,), 0, jnp.maximum(gb.history_len, 1)
    )
    return gb.history[idx]


def sample_nearby(
    key: jnp.ndarray,
    gb: GenBufferState,
    num: int,
    grid: Grid,
    num_agents: int,
    num_cylinders: int,
    expand_step: float,
    expand_cylinders: bool,
    arena_size: float,
    max_height: float,
    num_tries: int = 10,
) -> jnp.ndarray:
    """Noise-expand buffer tasks with a grid sanity check
    (hideandseek_envgen.py:316-370).

    For each task: up to `num_tries` noise draws; the first whose entities
    all land on distinct free cells wins; otherwise fall back to the
    unperturbed original (which is valid by construction).
    """
    k_pick, k_noise = jax.random.split(key)
    origin = sample_history(k_pick, gb, num)          # [num, D]
    d = origin.shape[-1]
    dt_dim = 3 * (num_agents + 1)

    # clip boundaries (hideandseek_envgen.py:321-333)
    cylinder_boundary = int(arena_size / grid.grid_size) * grid.grid_size
    bxy = arena_size / np.sqrt(2.0) - 0.1
    lo_dt = np.tile([-bxy, -bxy, max_height - 0.1], num_agents + 1)
    hi_dt = np.tile([bxy, bxy, max_height + 0.1], num_agents + 1)
    lo_c = np.tile([-cylinder_boundary, -cylinder_boundary, -20.0], num_cylinders)
    hi_c = np.tile(
        [cylinder_boundary, cylinder_boundary, max_height / 2], num_cylinders
    )
    lo = jnp.asarray(np.concatenate([lo_dt, lo_c]), origin.dtype)
    hi = jnp.asarray(np.concatenate([hi_dt, hi_c]), origin.dtype)

    k_dt, k_cyl = jax.random.split(k_noise)
    dt_noise = (
        jax.random.uniform(k_dt, (num_tries, num, dt_dim), minval=-1.0, maxval=1.0)
        * expand_step
    )
    cyl_xy = (
        jax.random.randint(k_cyl, (num_tries, num, num_cylinders, 2), -1, 2)
        .astype(origin.dtype)
        * grid.grid_size
    )
    if not expand_cylinders:
        cyl_xy = jnp.zeros_like(cyl_xy)
    cyl_noise = jnp.concatenate(
        [cyl_xy, jnp.zeros((num_tries, num, num_cylinders, 1), origin.dtype)],
        axis=-1,
    ).reshape(num_tries, num, -1)
    noise = jnp.concatenate([dt_noise, cyl_noise], axis=-1)
    candidates = jnp.clip(origin[None] + noise, lo, hi)   # [T, num, D]

    ok = _sanity_check(candidates, grid, num_agents, num_cylinders)  # [T, num]
    # first valid try per task; fall back to the original task
    any_ok = jnp.any(ok, axis=0)                                    # [num]
    first = jnp.argmax(ok, axis=0)                                  # [num]
    chosen = jnp.take_along_axis(
        candidates, first[None, :, None], axis=0
    )[0]
    return jnp.where(any_ok[:, None], chosen, origin)


def _sanity_check(
    tasks: jnp.ndarray, grid: Grid, num_agents: int, num_cylinders: int
) -> jnp.ndarray:
    """All entities on distinct, inside-circle cells
    (hideandseek_envgen.py:185-207), and the expanded layout must keep a
    feasible drone→target path (placement.py:54-101 — the reference runs
    the DFS check inside its rejection loops; expansion noise can close a
    passage, so the check belongs here too).  tasks: [..., D] → bool [...]."""
    pts = tasks.reshape(tasks.shape[:-1] + (num_agents + 1 + num_cylinders, 3))
    cells = continuous_to_grid(pts[..., :2], grid)       # [..., P, 2]
    flat = cells[..., 0] * grid.num_grid + cells[..., 1]  # [..., P]
    outside = jnp.asarray(outside_circle_mask(grid.num_grid)).reshape(-1)
    hits_outside = jnp.any(outside[flat], axis=-1)
    # distinct cells: compare all pairs
    dup = jnp.any(
        (flat[..., :, None] == flat[..., None, :])
        & (~jnp.eye(flat.shape[-1], dtype=bool)),
        axis=(-2, -1),
    )
    n = num_agents
    cyl = pts[..., n + 1 :, :]
    feas = feasible_layout(
        pts[..., :n, :2], pts[..., n : n + 1, :2],
        cyl[..., :2], cyl[..., 2] > 0.0, grid,
    )
    return ~(hits_outside | dup) & feas


def insert_weights(gb: GenBufferState, success: jnp.ndarray) -> GenBufferState:
    """Accumulate per-env success at episode end
    (hideandseek_envgen.py:288-289, 1307)."""
    return gb.replace(
        weight_sum=gb.weight_sum + success, weight_count=gb.weight_count + 1
    )


def update_history(
    gb: GenBufferState, r_min: float, r_max: float, eps: float = 1e-5
) -> Tuple[GenBufferState, jnp.ndarray]:
    """Close one eval cycle: filter tasks with R_min ≤ success ≤ R_max into
    the history buffer, FPS-downsampled to capacity
    (hideandseek_envgen.py:291-314, 1324-1330).

    Returns (new_buffer_state, num_added).
    """
    cap, d = gb.history.shape
    e = gb.eval_tasks.shape[0]
    weights = gb.weight_sum / jnp.maximum(gb.weight_count, 1)
    keep = (weights >= r_min) & (weights <= r_max)            # [E]
    num_added = jnp.sum(keep)

    # concatenate [history (valid prefix), kept eval tasks] into one
    # fixed-size pool, then FPS-select `cap`.
    pool = jnp.concatenate([gb.history, gb.eval_tasks], axis=0)  # [cap+E, D]
    pool_valid = jnp.concatenate(
        [jnp.arange(cap) < gb.history_len, keep], axis=0
    )
    total = gb.history_len + num_added

    def fps_path(_):
        lo = jnp.min(jnp.where(pool_valid[:, None], pool, jnp.inf), axis=0)
        hi = jnp.max(jnp.where(pool_valid[:, None], pool, -jnp.inf), axis=0)
        norm = (pool - lo) / (hi - lo + eps)
        norm = jnp.where(pool_valid[:, None], norm, 1e6)
        # start from the first valid point to mirror DGL's start at index 0
        start = jnp.argmax(pool_valid).astype(jnp.int32)
        idx = farthest_point_sampling(norm, cap, valid=pool_valid, start_index=start)
        return pool[idx], jnp.asarray(cap, jnp.int32)

    def pack_path(_):
        # fits without downsampling: stable-sort valid entries to the front
        order = jnp.argsort(~pool_valid, stable=True)
        return pool[order][:cap], jnp.minimum(total, cap).astype(jnp.int32)

    history, history_len = jax.lax.cond(
        total > cap, fps_path, pack_path, operand=None
    )
    gb = gb.replace(
        history=history,
        history_len=history_len,
        weight_sum=jnp.zeros_like(gb.weight_sum),
        weight_count=jnp.zeros_like(gb.weight_count),
    )
    return gb, num_added
