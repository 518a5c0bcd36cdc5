"""Worker for the 2-process fake-DCN test (launched by test_multihost.py).

Each process contributes 2 virtual CPU devices; `jax.distributed` over
localhost forms the 4-device global mesh, and `harness.train` runs the
standard loop on globally-sharded arrays (SURVEY §5.8).
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

pid, nproc, port, run_dir = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
)
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# two processes compile the same programs at once: keep them off the
# shared persistent cache
jax.config.update("jax_enable_compilation_cache", False)
jax.distributed.initialize(
    coordinator_address=f"localhost:{port}", num_processes=nproc, process_id=pid
)

from mupe_tpu.harness import train  # noqa: E402

metrics = train(
    [
        "env.num_envs=16",
        "env.max_episode_length=16",
        "max_iters=2",
        "log_interval=1",
        "save_interval=-1",
        "algo.train_every=8",
        "algo.num_minibatches=2",
        f"run_dir={run_dir}",
        "run_name=shared",
    ],
    default_task="Hover",
)
print("METRICS " + json.dumps({k: float(v) for k, v in metrics.items()}))
