#!/usr/bin/env python
"""HideAndSeek scripted-rollout demo: step the full task (PID-rate CTBR →
dynamics → evader potential field → reward) with a naive pursuit policy
and print episode stats; optionally save a GIF with --gif.

Runs on CPU with a small batch; no training, no simulator.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np

from mupe_tpu.envs.hideandseek import HideAndSeek, HideAndSeekCfg


def main():
    cfg = HideAndSeekCfg(num_envs=4, max_episode_length=200, use_tp_net=False)
    env = HideAndSeek(cfg)
    key = jax.random.PRNGKey(0)
    state = env.reset(key)

    def chase_action(state):
        """Naive pursuit: pitch toward the evader, hover-ish thrust."""
        rpos = state.target_pos - state.drone.pos          # [E, n, 3]
        yaw_err = jnp.arctan2(rpos[..., 1], rpos[..., 0])
        pitch = jnp.clip(jnp.linalg.norm(rpos[..., :2], axis=-1), 0.0, 0.3)
        climb = jnp.clip(rpos[..., 2], -0.3, 0.3)
        # action = [rate_roll, rate_pitch, rate_yaw, thrust] pre-tanh
        return jnp.stack(
            [jnp.zeros_like(pitch), 0.3 * pitch, 0.5 * yaw_err,
             0.1 * climb], axis=-1,
        )

    @jax.jit
    def run(state, key):
        def body(carry, k):
            state = carry
            state, tr = env.step(state, chase_action(state), k)
            frame = {
                "drone_pos": tr.info["drone_state"][..., :3],
                "target_pos": tr.info["target_pos"],
                "cylinders": tr.info["cylinders"],
                "capture": tr.info["capture"],
            }
            return state, (tr.done, tr.stats, frame)

        keys = jax.random.split(key, cfg.max_episode_length)
        return jax.lax.scan(body, state, keys)

    _, (done, stats, frames) = run(state, jax.random.PRNGKey(1))
    done = np.asarray(done)
    n_done = int(done.sum())
    if n_done == 0:
        print("no episodes completed within max_episode_length — "
              "stats unavailable (raise max_episode_length or num_envs)")
    else:
        print(f"episode stats (scripted chase policy, {n_done} episodes):")
        for k in ("success", "catch_reward", "distance_reward", "collision",
                  "first_capture_step"):
            v = float((np.asarray(stats[k]) * done).sum() / n_done)
            print(f"  {k:22s} {v:8.3f}")

    if "--gif" in sys.argv:
        from mupe_tpu.utils.render import episode_video

        path = episode_video(
            {k: np.asarray(v) for k, v in frames.items()}, cfg,
            "demo_hideandseek.gif", env_index=0,
        )
        print(f"gif: {path}")


if __name__ == "__main__":
    main()
