"""Checkpoint completeness (SURVEY §5.4, VERDICT r1 item 7): the full-carry
checkpoint must round-trip the learner state, env curriculum scalars, the
AEG buffer and the PRNG key so a resumed run continues bit-identically."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mupe_tpu.envs.hideandseek_envgen import HideAndSeekEnvgen, HideAndSeekEnvgenCfg
from mupe_tpu.learning import MAPPOCfg, MAPPOPolicy, init_carry, make_split_train_iter
from mupe_tpu.utils.checkpoint import load_checkpoint, save_checkpoint


def _tiny():
    env_cfg = HideAndSeekEnvgenCfg(
        num_envs=8, max_episode_length=8, buffer_length=32
    )
    env = HideAndSeekEnvgen(env_cfg)
    policy = MAPPOPolicy(
        MAPPOCfg(train_every=8, num_minibatches=2, use_tp_net=True),
        n_agents=env.num_agents,
        action_dim=4,
        obs_is_dict=True,
        tp_input_dim=env_cfg.tp_input_dim,
    )
    return env, policy


def test_full_carry_roundtrip_resumes_identically(tmp_path):
    env, policy = _tiny()
    train_iter = make_split_train_iter(env, policy)
    carry = init_carry(env, policy, jax.random.PRNGKey(0))
    carry, _, _ = train_iter(carry)  # 1 train iter (episodes end inside)

    save_checkpoint(tmp_path, 1, carry)

    # restore onto a ZEROED template: every value must come from disk
    template = jax.tree_util.tree_map(lambda x: np.zeros_like(x), carry)
    restored = load_checkpoint(tmp_path, target=template)

    # curriculum scalars + AEG buffer survived
    np.testing.assert_array_equal(
        np.asarray(restored.env_state.v_prey), np.asarray(carry.env_state.v_prey)
    )
    np.testing.assert_array_equal(
        np.asarray(restored.env_state.gen.history),
        np.asarray(carry.env_state.gen.history),
    )
    np.testing.assert_array_equal(
        np.asarray(restored.env_state.gen.history_len),
        np.asarray(carry.env_state.gen.history_len),
    )

    # continuation is bit-identical: same metrics from original and restored
    _, m_a, s_a = train_iter(carry)
    _, m_b, s_b = train_iter(restored)
    for k in m_a:
        np.testing.assert_allclose(
            np.asarray(m_a[k]), np.asarray(m_b[k]), rtol=0, atol=0,
            err_msg=f"metric {k} diverged after resume",
        )
    for k in s_a:
        np.testing.assert_allclose(
            np.asarray(s_a[k]), np.asarray(s_b[k]), rtol=0, atol=0,
            err_msg=f"stat {k} diverged after resume",
        )


def test_harness_resume_dir(tmp_path):
    """`resume_dir` wiring through the real entry point."""
    from mupe_tpu.harness import train

    common = [
        "env.num_envs=8",
        "env.max_episode_length=8",
        "env.buffer_length=16",
        "algo.train_every=8",
        "algo.num_minibatches=2",
        "log_interval=1",
        f"run_dir={tmp_path}",
    ]
    train(common + ["max_iters=1", "run_name=a", "save_interval=1"],
          default_task="HideAndSeek_envgen")
    m = train(
        common + [
            "max_iters=1",
            "run_name=b",
            "save_interval=-1",
            f"resume_dir={tmp_path}/a/checkpoints/full",
        ],
        default_task="HideAndSeek_envgen",
    )
    assert np.isfinite(m["policy_loss"])


def test_schema_tolerant_restore_of_old_checkpoint(tmp_path):
    """A checkpoint written BEFORE a state field existed must still restore
    (round-4 advisor, medium): the stored tree is a strict subset of the
    target — missing leaves keep the target's defaults, present leaves come
    from disk.  Emulates a pre-round-4 GenBufferState (no `dry_cycles`) by
    saving a dict with the same field names minus the new one (orbax's
    flattened storage layout is identical)."""
    from mupe_tpu.envs.genbuffer import GenBufferState

    target = GenBufferState.create(
        buffer_length=16, num_envs=4, task_dim=6, ratio_unif=0.5
    )
    target = target.replace(dry_cycles=jnp.asarray(7, jnp.int32))
    old = {
        f: np.asarray(getattr(target, f)) * 0 + 3
        for f in (
            "history", "history_len", "eval_tasks", "weight_sum",
            "weight_count", "update_iter", "ratio_unif",
        )
    }
    save_checkpoint(tmp_path / "old", 5, old)

    with pytest.warns(UserWarning, match="dry_cycles"):
        restored = load_checkpoint(tmp_path / "old", target=target)
    # stored fields come from disk
    np.testing.assert_array_equal(np.asarray(restored.history), 3.0)
    np.testing.assert_array_equal(np.asarray(restored.weight_count), 3)
    # the missing field keeps the target's value
    assert int(restored.dry_cycles) == 7


def test_npz_round_trip_of_sharded_carry(tmp_path):
    """A carry sharded over the 8-device mesh (env leaves split, learner
    replicated) round-trips through `.npz`: values from disk, each leaf
    restored onto its target's sharding."""
    from mupe_tpu.envs.hideandseek import HideAndSeek, HideAndSeekCfg
    from mupe_tpu.parallel import make_mesh

    mesh = make_mesh()
    env = HideAndSeek(HideAndSeekCfg(num_envs=8, max_episode_length=8))
    policy = MAPPOPolicy(
        MAPPOCfg(train_every=8, num_minibatches=2, use_tp_net=True),
        n_agents=env.num_agents, action_dim=4, obs_is_dict=True,
        tp_input_dim=env.cfg.tp_input_dim,
    )
    saved = init_carry(env, policy, jax.random.PRNGKey(0), mesh=mesh)
    save_checkpoint(tmp_path, 3, saved)
    assert (tmp_path / "step_3.npz").exists()
    other = init_carry(env, policy, jax.random.PRNGKey(1), mesh=mesh)
    restored = load_checkpoint(tmp_path, target=other)

    flat = lambda t: jax.tree_util.tree_leaves(t)
    for a, b, t in zip(flat(restored), flat(saved), flat(other)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert a.sharding == t.sharding
    pos = restored.env_state.drone.pos
    assert len(pos.sharding.device_set) == 8
    assert not np.array_equal(
        np.asarray(saved.env_state.drone.pos), np.asarray(other.env_state.drone.pos)
    )
