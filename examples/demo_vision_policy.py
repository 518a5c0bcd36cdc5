#!/usr/bin/env python
"""Train a depth-vision hover policy end-to-end (toy scale).

Hover emits an onboard depth frame (`env.obs_depth=true`, rendered by the
analytic ray-cast camera in sensors/depth.py) next to the flat state; the
`ppo_vision` policy consumes both through MixedObsEncoder (conv branch +
MLP branch).  The reference ships a camera (sensors/camera.py:40) and a
MixedEncoder (networks.py:322-368) but never trains through them — this
demo drives the full chain.

Usage: python examples/demo_vision_policy.py  (~1-2 min on CPU, faster on a GPU)
"""
import sys

import jax
import numpy as np

sys.path.insert(0, ".")

from mupe_tpu.envs.hover import Hover, HoverCfg
from mupe_tpu.learning import init_carry, make_train_iter
from mupe_tpu.learning.registry import make_policy


def main():
    env = Hover(
        HoverCfg(
            num_envs=256, max_episode_length=200,
            obs_depth=True, depth_width=16, depth_height=12,
        )
    )
    policy = make_policy(
        "ppo_vision", env, {"train_every": 16, "num_minibatches": 4}
    )
    carry = init_carry(env, policy, jax.random.PRNGKey(0))
    it = jax.jit(make_train_iter(env, policy))
    print("iter  policy_loss  value_loss  pos_error  episodes")
    for i in range(30):
        carry, metrics, stats = it(carry)
        if (i + 1) % 5 == 0:
            n_ep = float(np.asarray(stats["episode_count"]))
            pe = float(np.asarray(stats["pos_error"]))
            print(
                f"{i+1:4d}  {float(np.asarray(metrics['policy_loss'])):+10.4f}"
                f"  {float(np.asarray(metrics['value_loss'])):10.4f}"
                + (f"  {pe:9.4f}" if n_ep > 0 else "     (none)")
                + f"  {n_ep:8.0f}"
            )
    print("done — vision policy trained through the conv depth branch")


if __name__ == "__main__":
    main()
