#!/usr/bin/env python
"""HideAndSeek MAPPO training throughput in env-steps/s.

The reference's headline workload (BASELINE.md): 3-agent HideAndSeek with
random cylinders, TP-net, and the full MAPPO training iteration (rollout of
64 steps × num_envs arenas + PPO/TP update), end-to-end on device.  Prints
ONE JSON line with the rate and the device it ran on:
    {"metric": ..., "value": N, "unit": ..., "device": {...}}
Sizes: BENCH_NUM_ENVS (4096), BENCH_TRAIN_EVERY (64), BENCH_ITERS (10).
"""
import json
import os
import sys
import time

import jax

NUM_ENVS = int(os.environ.get("BENCH_NUM_ENVS", 4096))
TRAIN_EVERY = int(os.environ.get("BENCH_TRAIN_EVERY", 64))
WARMUP = 2
ITERS = int(os.environ.get("BENCH_ITERS", 10))


def main():
    from mupe_tpu.envs.hideandseek import HideAndSeek, HideAndSeekCfg
    from mupe_tpu.learning import (
        MAPPOCfg,
        MAPPOPolicy,
        init_carry,
        make_split_train_iter,
    )
    from mupe_tpu.parallel import make_mesh, shard_carry
    from mupe_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    env_cfg = HideAndSeekCfg(num_envs=NUM_ENVS, max_episode_length=800)
    env = HideAndSeek(env_cfg)
    algo_cfg = MAPPOCfg(train_every=TRAIN_EVERY, use_tp_net=True)
    policy = MAPPOPolicy(
        algo_cfg,
        n_agents=env.num_agents,
        action_dim=4,
        obs_is_dict=True,
        tp_input_dim=env_cfg.tp_input_dim,
    )
    carry = init_carry(env, policy, jax.random.PRNGKey(0))
    mesh = make_mesh()
    if mesh.devices.size > 1:
        carry = shard_carry(carry, mesh)
    train_iter = make_split_train_iter(env, policy)

    for _ in range(WARMUP):
        carry, metrics, _ = train_iter(carry)
    jax.block_until_ready(carry)

    t0 = time.perf_counter()
    for _ in range(ITERS):
        carry, metrics, _ = train_iter(carry)
    jax.block_until_ready((carry, metrics))
    dt = time.perf_counter() - t0

    steps_per_s = NUM_ENVS * TRAIN_EVERY * ITERS / dt
    d = jax.devices()[0]
    print(
        json.dumps(
            {
                "metric": "hideandseek_mappo_env_steps_per_s",
                "value": steps_per_s,
                "unit": "env-steps/s (rollout+update, "
                f"{NUM_ENVS} arenas x {TRAIN_EVERY} steps)",
                "device": {
                    "platform": d.platform,
                    "kind": d.device_kind,
                    "count": len(jax.devices()),
                },
            }
        )
    )


if __name__ == "__main__":
    sys.exit(main())
