"""HideAndSeek + Adaptive Environment Generator (paper contribution #2).

Port of the reference `HideAndSeek_envgen`
(omni_drones/envs/hide_and_seek/hideandseek_envgen.py:379-1562): the same
pursuit-evasion task, but reset tasks are drawn from a particle buffer of
intermediate-difficulty tasks (`GenBuffer`) mixed with uniform sampling.

The AEG cycle (hideandseek_envgen.py:875-902, 1302-1333):
  * every `eval_iter` episodes, sample a fresh task set: `ratio_unif`
    uniform + the rest noise-expanded from the history buffer;
  * each task set is replayed `eval_iter` times; per-env success is averaged;
  * tasks with success in [R_min, R_max] enter the history buffer,
    farthest-point-downsampled to capacity;
  * if overall success > success_threshold, fall back to pure uniform.

Everything — including the FPS downsampling the reference delegates to DGL's
CUDA kernel — runs on device inside the jitted step; episode boundaries are
synchronized (fixed episode length), so the cycle advances under a
`lax.cond` on `any(done)`.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .base import register_env
from .genbuffer import (
    GenBufferState,
    insert_weights,
    sample_nearby,
    update_history,
)
from .hideandseek import (
    STAT_KEYS,
    HideAndSeek,
    HideAndSeekCfg,
    HideAndSeekState,
)
from .scenarios import INVALID_Z


@dataclasses.dataclass(frozen=True)
class HideAndSeekEnvgenCfg(HideAndSeekCfg):
    """AEG knobs (reference cfg/task/HideAndSeek_envgen.yaml:28-38)."""

    use_particle_generator: bool = True
    use_init_easy_cases: bool = False
    ratio_unif: float = 0.3
    eval_iter: int = 3
    success_threshold: float = 1.0
    expand_cylinders: bool = False
    expand_step: float = 0.1
    r_min: float = 0.5
    r_max: float = 0.9
    buffer_length: int = 5000
    # ---- starvation fallback (round-4; mirrors the success_threshold
    # fallback of hideandseek_envgen.py:1302-1304 in the opposite
    # direction).  The r3 1.07B-frame extension stalled once success sank
    # below r_min: update_history then ingests ~nothing and the buffer
    # replays the same stale tasks forever.  After `starve_cycles`
    # consecutive zero-ingestion cycles, the effective uniform mix is
    # raised to `starve_ratio_unif` (easier on-average tasks → success
    # recovers → ingestion resumes → boost lifts).  0 disables.
    starve_cycles: int = 0
    starve_ratio_unif: float = 1.0

    @property
    def task_dim(self) -> int:
        # [drone (n·3), target (3), cylinders (C·3)] (hideandseek_envgen.py:212)
        return 3 * self.num_agents + 3 + 3 * self.num_cylinders


def envgen_extra_stats(num_cylinders: int):
    """Per-instance stat keys: the cylinder strata run 0..num_cylinders
    inclusive (matching _auto_reset), not a fixed 0..5."""
    return (
        ("add_history", "history_buffer", "ratio_unif", "dry_cycles")
        + tuple(f"ratio_cylinders_{i}" for i in range(num_cylinders + 1))
        + tuple(f"success_cylinders_{i}" for i in range(num_cylinders + 1))
    )


# default-capacity keys (num_cylinders=5) for backwards compatibility
ENVGEN_EXTRA_STATS = envgen_extra_stats(5)


@register_env("HideAndSeek_envgen")
class HideAndSeekEnvgen(HideAndSeek):
    """AEG task variant; shares the full step machinery with HideAndSeek."""

    def __init__(self, cfg: HideAndSeekEnvgenCfg = HideAndSeekEnvgenCfg()):
        super().__init__(cfg)
        self._extra_stats = envgen_extra_stats(cfg.num_cylinders)
        self.stat_keys = STAT_KEYS + self._extra_stats
        # the easy-case bootstrap runs the HOST-side C++ BFS generator —
        # precompute it eagerly here so `reset` stays jit-safe (inside a
        # trace the numpy round-trip would hit a tracer; init_carry jits
        # reset)
        self._easy_tasks = (
            self._easy_history() if cfg.use_init_easy_cases else None
        )

    # -------------------------------------------------------------- tasks
    def _tasks_to_scene(self, tasks: jnp.ndarray):
        """Flat task vectors → (drone_pos, target_pos, cylinders)."""
        cfg: HideAndSeekEnvgenCfg = self.cfg
        e = tasks.shape[0]
        n = cfg.num_agents
        drone_pos = tasks[..., : 3 * n].reshape(e, n, 3)
        target_pos = tasks[..., 3 * n : 3 * n + 3].reshape(e, 1, 3)
        cylinders = tasks[..., 3 * n + 3 :].reshape(e, cfg.num_cylinders, 3)
        return drone_pos, target_pos, cylinders

    def _scene_to_tasks(self, drone_pos, target_pos, cylinders) -> jnp.ndarray:
        e = drone_pos.shape[0]
        return jnp.concatenate(
            [
                drone_pos.reshape(e, -1),
                target_pos.reshape(e, -1),
                cylinders.reshape(e, -1),
            ],
            axis=-1,
        )

    def _uniform_tasks(self, key: jnp.ndarray) -> jnp.ndarray:
        """Uniform task sampling (hideandseek_envgen.py:860-873) — reuses the
        base scene sampler."""
        drone_pos, _, target_pos, cylinders, _, _ = self._sample_scene(key)
        return self._scene_to_tasks(drone_pos, target_pos, cylinders)

    def _easy_history(self, seed: int = 0) -> jnp.ndarray:
        """Bootstrap the history buffer with BFS-adjacent easy capture tasks
        (GenBuffer.init_easy_cases, hideandseek_envgen.py:235-275) via the
        native C++ generator (mupe_tpu/native/easy_tasks.cpp)."""
        import numpy as np

        from ..native import generate_easy_tasks
        from .placement import grid_to_continuous

        cfg: HideAndSeekEnvgenCfg = self.cfg
        cells = generate_easy_tasks(
            cfg.buffer_length, self.grid.num_grid, cfg.num_agents, seed
        )  # [L, n+1, 2]
        xy = np.asarray(grid_to_continuous(jnp.asarray(cells), self.grid))
        rng = np.random.default_rng(seed)
        z = (
            rng.uniform(-0.1, 0.1, size=(cfg.buffer_length, cfg.num_agents + 1, 1))
            + cfg.max_height / 2
        ).astype(np.float32)
        drone_target = np.concatenate([xy, z], axis=-1)  # [L, n+1, 3]
        # park all cylinders underground: 0-obstacle easy tasks
        cyl = np.zeros((cfg.buffer_length, cfg.num_cylinders, 3), np.float32)
        cyl[..., 0] = np.arange(cfg.num_cylinders) * 2 * cfg.cylinder_size
        cyl[..., 2] = INVALID_Z
        tasks = np.concatenate(
            [
                drone_target[:, : cfg.num_agents].reshape(cfg.buffer_length, -1),
                drone_target[:, cfg.num_agents :].reshape(cfg.buffer_length, -1),
                cyl.reshape(cfg.buffer_length, -1),
            ],
            axis=-1,
        )
        return jnp.asarray(tasks)

    # -------------------------------------------------------------- reset
    def reset(self, key: jnp.ndarray) -> HideAndSeekState:
        cfg: HideAndSeekEnvgenCfg = self.cfg
        k_tasks, k_state = jax.random.split(key)
        state = super().reset(k_state)
        tasks = self._uniform_tasks(k_tasks)
        gen = GenBufferState.create(
            cfg.buffer_length, cfg.num_envs, cfg.task_dim, cfg.ratio_unif
        ).replace(eval_tasks=tasks)
        if cfg.use_init_easy_cases:
            gen = gen.replace(
                history=self._easy_tasks,
                history_len=jnp.asarray(cfg.buffer_length, jnp.int32),
            )
        state = state.replace(gen=gen)
        return self._apply_tasks(state, tasks)

    def _apply_tasks(
        self, state: HideAndSeekState, tasks: jnp.ndarray
    ) -> HideAndSeekState:
        """Place drones/target/cylinders according to `tasks` (positions
        only; attitude/throttle already freshly sampled)."""
        drone_pos, target_pos, cylinders = self._tasks_to_scene(tasks)
        state = state.replace(
            drone=state.drone.replace(pos=drone_pos),
            target_pos=target_pos,
            cylinders=cylinders,
        )
        # re-prime the TP history for the new positions
        frame = self._tp_frame(state)
        return state.replace(
            history=jnp.repeat(
                frame[:, None, :], self.cfg.history_step, axis=1
            )
        )

    # -------------------------------------------------------------- AEG hook
    def _auto_reset(self, mid, st, done_env, key):
        cfg: HideAndSeekEnvgenCfg = self.cfg
        if not (cfg.use_particle_generator and cfg.use_random_cylinder):
            return super()._auto_reset(mid, st, done_env, key)

        gb: GenBufferState = mid.gen
        any_done = jnp.any(done_env)
        e = cfg.num_envs

        # success > threshold ⇒ pure uniform (hideandseek_envgen.py:1302-1304)
        mean_success = jnp.mean(st["success"])
        ratio_unif = jnp.where(
            any_done & (mean_success > cfg.success_threshold),
            1.0,
            gb.ratio_unif,
        )
        gb = gb.replace(ratio_unif=ratio_unif)

        # per-episode weight accumulation (:1307)
        gb = jax.lax.cond(
            any_done,
            lambda g: insert_weights(g, st["success"][:, 0]),
            lambda g: g,
            gb,
        )
        update_iter = jnp.where(any_done, gb.update_iter + 1, gb.update_iter)

        # close the eval cycle: filter into history + FPS (:1310-1330)
        cycle_done = any_done & (update_iter >= cfg.eval_iter)

        def do_update(g):
            g2, num_added = update_history(g, cfg.r_min, cfg.r_max)
            return g2, num_added.astype(jnp.float32)

        gb, num_added = jax.lax.cond(
            cycle_done,
            do_update,
            lambda g: (g, jnp.zeros((), jnp.float32)),
            gb,
        )
        update_iter = jnp.where(cycle_done, 0, update_iter)
        gb = gb.replace(update_iter=update_iter)

        # starvation fallback: count consecutive zero-ingestion cycles and
        # boost the uniform mix while starving (see HideAndSeekEnvgenCfg)
        if cfg.starve_cycles > 0:
            dry = jnp.where(
                cycle_done,
                jnp.where(num_added > 0, 0, gb.dry_cycles + 1),
                gb.dry_cycles,
            ).astype(jnp.int32)
            gb = gb.replace(dry_cycles=dry)
            eff_ratio = jnp.where(
                dry >= cfg.starve_cycles,
                jnp.maximum(gb.ratio_unif, cfg.starve_ratio_unif),
                gb.ratio_unif,
            )
        else:
            eff_ratio = gb.ratio_unif

        # fresh state via the parent (new attitudes, throttle, stats, …)
        new_state = super()._auto_reset(mid, st, done_env, key)

        # when a new cycle starts, draw a new task set (:881-895)
        k_unif, k_nearby, k_mix = jax.random.split(
            jax.random.fold_in(key, 1), 3
        )
        num_buffer = jnp.minimum(
            gb.history_len,
            (e * (1.0 - eff_ratio)).astype(jnp.int32),
        )

        def resample(g):
            unif = self._uniform_tasks(k_unif)
            nearby = sample_nearby(
                k_nearby, g, e, self.grid, cfg.num_agents, cfg.num_cylinders,
                cfg.expand_step, cfg.expand_cylinders, cfg.arena_size,
                cfg.max_height,
            )
            # first (E − num_buffer) uniform, rest from the buffer (:885-892)
            use_buffer = jnp.arange(e) >= (e - num_buffer)
            return jnp.where(use_buffer[:, None], nearby, unif)

        resample_needed = any_done & (update_iter == 0)
        tasks = jax.lax.cond(
            resample_needed, resample, lambda g: g.eval_tasks, gb
        )
        gb = gb.replace(eval_tasks=tasks)

        # apply tasks to the envs that reset (all of them, synchronized)
        placed = self._apply_tasks(new_state, tasks)
        new_state = new_state.replace(
            drone=new_state.drone.replace(
                pos=jnp.where(done_env[:, None, None], placed.drone.pos,
                              new_state.drone.pos)
            ),
            target_pos=jnp.where(
                done_env[:, None, None], placed.target_pos, new_state.target_pos
            ),
            cylinders=jnp.where(
                done_env[:, None, None], placed.cylinders, new_state.cylinders
            ),
            history=jnp.where(
                done_env[:, None, None], placed.history, new_state.history
            ),
        )

        # envgen bookkeeping stats (:1314-1333)
        stats = dict(new_state.stats)
        active = jnp.sum(tasks[..., 3 * cfg.num_agents + 5 :: 3] > 0.0, axis=-1)
        ones = jnp.ones((e, 1))
        for i in range(cfg.num_cylinders + 1):
            ratio_i = jnp.mean((active == i).astype(jnp.float32))
            stats[f"ratio_cylinders_{i}"] = ones * ratio_i
            w = gb.weight_sum / jnp.maximum(gb.weight_count, 1)
            mask_i = active == i
            succ_i = jnp.sum(w * mask_i) / jnp.clip(jnp.sum(mask_i), 1, None)
            stats[f"success_cylinders_{i}"] = ones * succ_i
        stats["add_history"] = ones * num_added
        stats["history_buffer"] = ones * gb.history_len.astype(jnp.float32)
        stats["ratio_unif"] = ones * eff_ratio  # effective (incl. starvation boost)
        stats["dry_cycles"] = ones * gb.dry_cycles.astype(jnp.float32)
        return new_state.replace(stats=stats, gen=gb)

    def _fresh(self, key, v_prey, update_epoch):
        state = super()._fresh(key, v_prey, update_epoch)
        extra = {k: jnp.zeros((self.cfg.num_envs, 1)) for k in self._extra_stats}
        return state.replace(stats={**state.stats, **extra})
