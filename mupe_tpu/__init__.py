"""mupe_tpu — a JAX multi-UAV pursuit-evasion RL framework.

A from-scratch JAX/XLA re-design of the capabilities of
thu-uav/Multi-UAV-pursuit-evasion (OmniDrones-based MAPPO pursuit-evasion):

- ``mupe_tpu.core``        — quaternion/SE(3) math and PRNG utilities (L0).
- ``mupe_tpu.dynamics``    — pure-JAX quadrotor rigid-body simulator that replaces
  the reference's Isaac Sim / PhysX backend (L1).
- ``mupe_tpu.controllers`` — CTBR controllers (PID rate, Lee position, attitude,
  rate, DSL PID) as pure functions with explicit carry state (L2).
- ``mupe_tpu.envs``        — vectorized environments (Hover, HideAndSeek,
  HideAndSeek env-generator/AEG) as pure reset/step functions over an
  ``EnvState`` pytree, auto-reset inside ``jit`` (L3).
- ``mupe_tpu.transforms``  — action/observation adapters (the torchrl-transform
  equivalents) as pure functions composed into the rollout (L4).
- ``mupe_tpu.learning``    — MAPPO + TP-net, PPO family, encoders, distributions,
  GAE, value normalizers in JAX/optax (the PPO variant family on flax);
  whole train step jitted (L5).
- ``mupe_tpu.ops``         — the packed-row policy encoder of the PPO update
  and farthest-point sampling, in jnp.
- ``mupe_tpu.parallel``    — device-mesh sharding of the env/batch axis via
  ``jax.sharding`` (L7).
- ``mupe_tpu.utils``       — config, logging, stats, checkpointing (L6).

Everything on the compute path is functionally pure, statically shaped, and
compiled by XLA; there is no host↔device ping-pong inside the training loop.
"""

__version__ = "0.1.0"
