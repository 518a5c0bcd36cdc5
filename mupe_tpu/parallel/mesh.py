"""Device-mesh sharding of the environment axis.

The reference's only parallelism is vectorized arenas on one GPU
(SURVEY §2.6; cfg/base/env_base.yaml num_envs=4096).  Here the same arena
axis is sharded across a 1-D `jax.sharding.Mesh` of devices (GPUs of one
host, or of several hosts under `jax.distributed`): every leaf of the
env/rollout state carries the env axis first, policy/optimizer state is
replicated, and XLA's SPMD partitioner inserts the collectives (gradient
all-reduces across the data axis, gathers for global minibatch shuffling).  The networks are tiny (≤256 hidden), so tensor/pipeline/sequence
parallelism is intentionally out of scope — the env/batch axis is the only
sharded dimension, exactly mirroring (and scaling out) the reference.
"""
from __future__ import annotations

import os
from typing import Any, Optional, Sequence

import jax
from jax.sharding import AxisType, Mesh, NamedSharding, PartitionSpec as P

ENV_AXIS = "env"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join the multi-host JAX runtime (SURVEY §5.8: the reference has no
    distributed backend; here multi-host = `jax.distributed` + DCN).

    Arguments default to the env vars JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID.  A single-process run (no
    coordinator configured) is a no-op.  Returns True iff the distributed
    runtime was (or already is) initialized.
    """
    # NB: not jax.process_count() — it initializes the XLA backend, after
    # which initialize() is illegal
    if jax.distributed.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def make_mesh(devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """1-D data mesh over all (or the given) devices, in device order.

    The cards of one host are joined all to all (NVLink), so the order of
    the devices on the env axis does not matter.  `jax.devices()` is the
    *global* device list, so under `jax.distributed` the same 1-D env mesh
    spans hosts; the SPMD partitioner inserts the gradient reductions for
    the replicated learner (SURVEY §2.6)."""
    devices = list(jax.devices() if devices is None else devices)
    return jax.make_mesh(
        (len(devices),), (ENV_AXIS,), (AxisType.Auto,), devices=devices
    )


def local_env_slice(num_envs: int) -> slice:
    """This process's contiguous shard of the global env axis — for host
    code that prepares per-host data (e.g. AEG task injection) before
    assembling a global array with
    `jax.make_array_from_process_local_data`."""
    per = num_envs // jax.process_count()
    start = per * jax.process_index()
    return slice(start, start + per)


def env_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (env) axis."""
    return NamedSharding(mesh, P(ENV_AXIS))


def sharded_init_jit(fn, mesh: Mesh, num_envs: int):
    """jit `fn` with `out_shardings` that place leaves with a leading env
    axis on the mesh and replicate everything else.

    This is how initial state is created on multi-host: every process runs
    the same program with the same (replicated) inputs and the outputs are
    born as *global* arrays — no host-local → global assembly step, no
    cross-host `device_put`.  Works identically for single-host multi-chip
    meshes."""

    def call(*args):
        shapes = jax.eval_shape(fn, *args)
        es, rep = env_sharding(mesh), replicated(mesh)
        out_sh = jax.tree_util.tree_map(
            lambda s: es if (s.ndim >= 1 and s.shape[0] == num_envs) else rep,
            shapes,
        )
        return jax.jit(fn, out_shardings=out_sh)(*args)

    return call


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_env_tree(tree: Any, mesh: Mesh) -> Any:
    """Place every array leaf with leading env axis on the mesh; scalars and
    sub-env-sized leaves are replicated."""
    num = mesh.devices.size
    es, rep = env_sharding(mesh), replicated(mesh)

    def place(x):
        if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] % num == 0 and x.shape[0] > 0:
            return jax.device_put(x, es)
        return jax.device_put(x, rep)

    return jax.tree_util.tree_map(place, tree)


def shard_carry(carry, mesh: Mesh):
    """Shard an iteration carry (`IterCarry` or `RNNIterCarry`): env
    state/obs/hidden-state by env axis, learner state replicated."""
    updates = dict(
        ts=jax.device_put(carry.ts, replicated(mesh)),
        env_state=shard_env_tree(carry.env_state, mesh),
        obs=shard_env_tree(carry.obs, mesh),
        key=jax.device_put(carry.key, replicated(mesh)),
    )
    if hasattr(carry, "state") and carry.state is not None:
        updates["state"] = shard_env_tree(carry.state, mesh)
    for f in ("actor_rnn", "critic_rnn", "is_init"):
        if hasattr(carry, f):
            updates[f] = shard_env_tree(getattr(carry, f), mesh)
    return carry.replace(**updates)
