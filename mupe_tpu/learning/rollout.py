"""Fused rollout + update: the whole training iteration as one XLA program.

The reference's hot loop is a torchrl `SyncDataCollector` stepping the Isaac
sim across the Python/PhysX boundary 64 times, then `policy.train_op`
(scripts/train.py:269-300, utils/torchrl/collector.py:33-87).  Here the
rollout is a `lax.scan` of (policy → CTBR transform → dynamics → reward) and
the PPO update runs in the same jitted call — zero host↔device transfers per
iteration, one compiled program per config.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from ..core import struct
from .mappo import MAPPOPolicy, MAPPOState, RolloutBatch, pack_rollout_row


@struct.dataclass
class IterCarry:
    """Carried across training iterations (all on device)."""

    ts: MAPPOState
    env_state: Any
    obs: Any
    state: Any  # centralized-critic input (or None)
    key: jnp.ndarray


def make_train_iter(env, policy: MAPPOPolicy, deterministic: bool = False):
    """Build the fully-fused `train_iter(carry) -> (carry, metrics, ep_stats)`
    — one pure function for one `jax.jit` call.

    `env` must expose `step(state, action, key[, tp_params]) -> (state,
    Transition)`; Transition.info may carry "tp_input"/"tp_gt"/"tp_done" and
    "state" (centralized critic input).

    `make_split_train_iter` compiles the same iteration as two smaller
    programs (rollout, update) with identical semantics.
    """
    cfg = policy.cfg
    uses_tp = policy.tp_net is not None and getattr(env, "provides_tp", False)

    def make_rollout_step(pack_meta):
        def rollout_step(carry, key):
            ts, env_state, obs, state = carry
            k_act, k_env = jax.random.split(key)
            action, logp, value = policy.act(
                ts, obs, k_act, deterministic=deterministic, state=state
            )
            if uses_tp:
                env_state, tr = env.step(env_state, action, k_env, ts.tp_params)
            else:
                env_state, tr = env.step(env_state, action, k_env)
            collected = {
                "value": value,
                "reward": tr.reward,
                "done": tr.done,
                "stats": tr.stats,
            }
            if pack_meta is not None:
                # emit minibatch-ready wide rows; the scan's output stacking
                # writes them straight into the [T, E, D] buffer, so the
                # update's big pack-concat disappears
                collected["packed"] = pack_rollout_row(
                    pack_meta, obs, action, logp, value
                )
            else:
                collected["obs"] = obs
                collected["action"] = action
                collected["logp"] = logp
            if cfg.critic_input == "state":
                collected["state"] = state
            if uses_tp:
                collected["tp_input"] = tr.info["tp_input"]
                collected["tp_gt"] = tr.info["tp_gt"]
                collected["tp_done"] = tr.info["tp_done"]
            next_state_input = tr.info.get("state") if isinstance(tr.info, dict) else None
            return (ts, env_state, tr.obs, next_state_input), collected

        return rollout_step

    def train_iter(carry: IterCarry) -> Tuple[IterCarry, Dict, Dict]:
        key, k_roll, k_train = jax.random.split(carry.key, 3)
        step_keys = jax.random.split(k_roll, cfg.train_every)
        pack_meta = policy.pack_meta_for(carry.obs)
        (ts, env_state, last_obs, last_state), traj = jax.lax.scan(
            make_rollout_step(pack_meta),
            (carry.ts, carry.env_state, carry.obs, carry.state),
            step_keys,
        )
        batch = RolloutBatch(
            obs=traj.get("obs"),
            action=traj.get("action"),
            logp=traj.get("logp"),
            value=traj["value"],
            reward=traj["reward"],
            done=traj["done"],
            last_obs=last_obs,
            state=traj.get("state"),
            last_state=last_state,
            tp_input=traj.get("tp_input"),
            tp_gt=traj.get("tp_gt"),
            tp_done=traj.get("tp_done"),
            packed=traj.get("packed"),
        )
        ts, metrics = policy.train_op(ts, batch, k_train)

        # episode stats: mean over transitions that finished an episode
        # (the EpisodeStats harvester, scripts/train.py:53-79)
        done = traj["done"]  # [T, E, 1]
        n_done = jnp.sum(done)
        ep_stats = {
            k: jnp.sum(v * done) / jnp.clip(n_done, 1, None)
            for k, v in traj["stats"].items()
        }
        ep_stats["episode_count"] = n_done
        new_carry = IterCarry(
            ts=ts, env_state=env_state, obs=last_obs, state=last_state, key=key
        )
        return new_carry, metrics, ep_stats

    return train_iter


def make_rollout_update_progs(
    env, policy: MAPPOPolicy, deterministic: bool = False
):
    """The two halves of the split training iteration as separate jitted
    programs `(rollout_prog, update_prog)` — see `make_split_train_iter`.
    Exposed so each half can be timed on its own."""
    cfg = policy.cfg
    uses_tp = policy.tp_net is not None and getattr(env, "provides_tp", False)

    def make_rollout_step(pack_meta):
        def rollout_step(carry, key):
            ts, env_state, obs, state = carry
            k_act, k_env = jax.random.split(key)
            action, logp, value = policy.act(
                ts, obs, k_act, deterministic=deterministic, state=state
            )
            if uses_tp:
                env_state, tr = env.step(env_state, action, k_env, ts.tp_params)
            else:
                env_state, tr = env.step(env_state, action, k_env)
            collected = {
                "value": value,
                "reward": tr.reward,
                "done": tr.done,
                "stats": tr.stats,
            }
            if pack_meta is not None:
                collected["packed"] = pack_rollout_row(
                    pack_meta, obs, action, logp, value
                )
            else:
                collected["obs"] = obs
                collected["action"] = action
                collected["logp"] = logp
            if cfg.critic_input == "state":
                collected["state"] = state
            if uses_tp:
                collected["tp_input"] = tr.info["tp_input"]
                collected["tp_gt"] = tr.info["tp_gt"]
                collected["tp_done"] = tr.info["tp_done"]
            next_state_input = tr.info.get("state") if isinstance(tr.info, dict) else None
            return (ts, env_state, tr.obs, next_state_input), collected

        return rollout_step

    @jax.jit
    def rollout_prog(carry: IterCarry):
        key, k_roll = jax.random.split(carry.key)
        step_keys = jax.random.split(k_roll, cfg.train_every)
        (ts, env_state, last_obs, last_state), traj = jax.lax.scan(
            make_rollout_step(policy.pack_meta_for(carry.obs)),
            (carry.ts, carry.env_state, carry.obs, carry.state),
            step_keys,
        )
        done = traj["done"]
        n_done = jnp.sum(done)
        ep_stats = {
            k: jnp.sum(v * done) / jnp.clip(n_done, 1, None)
            for k, v in traj["stats"].items()
        }
        ep_stats["episode_count"] = n_done
        traj = {k: v for k, v in traj.items() if k != "stats"}
        new_carry = IterCarry(
            ts=ts, env_state=env_state, obs=last_obs, state=last_state, key=key
        )
        return new_carry, traj, ep_stats

    @jax.jit
    def update_prog(carry: IterCarry, traj):
        key, k_train = jax.random.split(carry.key)
        batch = RolloutBatch(
            obs=traj.get("obs"),
            action=traj.get("action"),
            logp=traj.get("logp"),
            value=traj["value"],
            reward=traj["reward"],
            done=traj["done"],
            last_obs=carry.obs,
            state=traj.get("state"),
            last_state=carry.state,
            tp_input=traj.get("tp_input"),
            tp_gt=traj.get("tp_gt"),
            tp_done=traj.get("tp_done"),
            packed=traj.get("packed"),
        )
        ts, metrics = policy.train_op(carry.ts, batch, k_train)
        return carry.replace(ts=ts, key=key), metrics

    return rollout_prog, update_prog


def make_split_train_iter(env, policy: MAPPOPolicy, deterministic: bool = False):
    """Semantically identical to `make_train_iter`, but compiled as TWO
    XLA programs — a rollout scan and the PPO/TP update — plus a tiny stats
    reducer.  All data stays on device between the calls; the only cost is
    two extra program dispatches per iteration, and each program compiles
    on its own.
    """
    rollout_prog, update_prog = make_rollout_update_progs(
        env, policy, deterministic
    )

    def train_iter(carry: IterCarry):
        carry, traj, ep_stats = rollout_prog(carry)
        carry, metrics = update_prog(carry, traj)
        return carry, metrics, ep_stats

    return train_iter


@struct.dataclass
class RNNIterCarry:
    """Iteration carry for recurrent policies (ppo_rnn): hidden states and
    the is_init flag ride along with the env state."""

    ts: Any
    env_state: Any
    obs: Any
    actor_rnn: jnp.ndarray
    critic_rnn: jnp.ndarray
    is_init: jnp.ndarray
    key: jnp.ndarray


def make_rnn_train_iter(env, policy, deterministic: bool = False):
    """Training iteration for `PPORNNPolicy` (reference ppo_rnn.py:177-414):
    the rollout threads GRU hidden states, records the pre-step states so
    BPTT chunks can resume from them, and flags episode starts (`is_init`)
    so the masked GRU re-zeroes at boundaries."""
    from .ppo.ppo_rnn import RNNRollout

    cfg = policy.cfg

    def rollout_step(carry, key):
        ts, env_state, obs, actor_rnn, critic_rnn, is_init = carry
        k_act, k_env = jax.random.split(key)
        action, logp, value, new_a, new_c = policy.act(
            ts, obs, actor_rnn, critic_rnn, is_init, k_act,
            deterministic=deterministic,
        )
        env_state, tr = env.step(env_state, action, k_env)
        collected = {
            "obs": obs,
            "action": action,
            "logp": logp,
            "value": value,
            "reward": tr.reward,
            "done": tr.done,
            "stats": tr.stats,
            "is_init": is_init,
            "actor_rnn": actor_rnn,
            "critic_rnn": critic_rnn,
        }
        # done [E, 1] → next-step is_init [E, n, 1]
        next_init = jnp.broadcast_to(
            tr.done[:, :, None], is_init.shape
        ).astype(bool)
        return (ts, env_state, tr.obs, new_a, new_c, next_init), collected

    @jax.jit
    def train_iter(carry: RNNIterCarry):
        key, k_roll, k_train = jax.random.split(carry.key, 3)
        step_keys = jax.random.split(k_roll, cfg.train_every)
        (ts, env_state, last_obs, last_a, last_c, last_init), traj = jax.lax.scan(
            rollout_step,
            (carry.ts, carry.env_state, carry.obs, carry.actor_rnn,
             carry.critic_rnn, carry.is_init),
            step_keys,
        )
        batch = RNNRollout(
            obs=traj["obs"],
            action=traj["action"],
            logp=traj["logp"],
            value=traj["value"],
            reward=traj["reward"],
            done=traj["done"],
            is_init=traj["is_init"],
            actor_rnn=traj["actor_rnn"],
            critic_rnn=traj["critic_rnn"],
            last_obs=last_obs,
            last_actor_rnn=last_a,
            last_critic_rnn=last_c,
            last_is_init=last_init,
        )
        ts, metrics = policy.train_op(ts, batch, k_train)
        done = traj["done"]
        n_done = jnp.sum(done)
        ep_stats = {
            k: jnp.sum(v * done) / jnp.clip(n_done, 1, None)
            for k, v in traj["stats"].items()
        }
        ep_stats["episode_count"] = n_done
        new_carry = RNNIterCarry(
            ts=ts, env_state=env_state, obs=last_obs, actor_rnn=last_a,
            critic_rnn=last_c, is_init=last_init, key=key,
        )
        return new_carry, metrics, ep_stats

    return train_iter


def init_rnn_carry(env, policy, key: jnp.ndarray, mesh=None) -> RNNIterCarry:
    """Reset the env and build the recurrent carry (hidden states zeroed,
    is_init=True everywhere so the masked GRU starts fresh)."""
    if mesh is not None:
        from ..parallel.mesh import replicated, sharded_init_jit

        env_jit = lambda f: sharded_init_jit(f, mesh, env.num_envs)
        rep_jit = lambda f: jax.jit(f, out_shardings=replicated(mesh))
    else:
        env_jit = rep_jit = jax.jit

    k_env, k_policy, k_next = jax.random.split(key, 3)
    env_state = env_jit(env.reset)(k_env)
    obs = env_jit(env.observe)(env_state)
    ts = rep_jit(policy.init)(k_policy, obs)
    h0, is_init = env_jit(
        lambda: (
            policy.zero_state(obs.shape[:-1]),
            jnp.ones(obs.shape[:-1] + (1,), bool),
        )
    )()
    return RNNIterCarry(
        ts=ts, env_state=env_state, obs=obs, actor_rnn=h0, critic_rnn=h0,
        is_init=is_init, key=k_next,
    )


def init_carry(
    env, policy: MAPPOPolicy, key: jnp.ndarray, mesh=None
) -> IterCarry:
    """Reset the env and build the initial on-device carry.

    TP params are created first because TP predictions feed the observation
    (hideandseek.py:316-319, 834).  Every stage is jitted, so the reset
    graph runs as one program per stage instead of op by op.

    With `mesh`, every stage is jitted with explicit out_shardings (env
    leaves on the env axis, learner state replicated) so the carry is born
    as global arrays — the multi-host path (SURVEY §5.8) and the multi-chip
    single-host path are the same code.
    """
    if mesh is not None:
        from ..parallel.mesh import replicated, sharded_init_jit

        env_jit = lambda f: sharded_init_jit(f, mesh, env.num_envs)
        rep_jit = lambda f: jax.jit(f, out_shardings=replicated(mesh))
    else:
        env_jit = rep_jit = jax.jit

    k_env, k_tp, k_policy, k_next = jax.random.split(key, 4)
    tp_params = rep_jit(policy.init_tp)(k_tp) if policy.tp_net else None
    env_state = env_jit(env.reset)(k_env)
    if hasattr(env, "observe_full"):
        obs, state = env_jit(env.observe_full)(env_state, tp_params)
    else:
        obs, state = env_jit(env.observe)(env_state), None
    ts = rep_jit(
        lambda k, o, s, tp: policy.init(k, o, state_example=s, tp_params=tp)
    )(k_policy, obs, state, tp_params)
    return IterCarry(ts=ts, env_state=env_state, obs=obs, state=state, key=k_next)
