"""Packed-rollout path (cfg.pack_rollout): the scan emits minibatch-ready
wide rows; train_op fills the reserved GAE columns and feeds column
slices straight to the encoder.  Must be bit-compatible with the legacy
collect-then-concat path (same RNG streams, same math on the same rows)."""
import jax
import jax.numpy as jnp
import numpy as np

from mupe_tpu.envs.hideandseek import HideAndSeek, HideAndSeekCfg
from mupe_tpu.learning import MAPPOCfg, MAPPOPolicy, init_carry
from mupe_tpu.learning.rollout import make_split_train_iter, make_train_iter


def _run(pack: bool, split: bool, iters=2):
    env = HideAndSeek(
        HideAndSeekCfg(num_envs=8, max_episode_length=16, num_agents=3)
    )
    cfg = MAPPOCfg(
        train_every=8, num_minibatches=2, ppo_epochs=2,
        use_tp_net=True, pack_rollout=pack,
    )
    policy = MAPPOPolicy(
        cfg, n_agents=3, action_dim=4, obs_is_dict=True,
        tp_input_dim=env.cfg.tp_input_dim,
    )
    carry = init_carry(env, policy, jax.random.PRNGKey(0))
    if split:
        train_iter = make_split_train_iter(env, policy)
    else:
        train_iter = jax.jit(make_train_iter(env, policy))
    for _ in range(iters):
        carry, metrics, stats = train_iter(carry)
    return carry, metrics


def test_packed_matches_legacy_fused_iter():
    # ONE iteration: the two paths feed bit-identical rows to the networks
    # (see the layout roundtrip test); remaining diffs are XLA
    # fusion/rounding (~1e-6 on the bf16 trunks) amplified by adam's ±lr
    # steps — same tolerance rationale as the direct-grad kernel parity
    # test.  (Across iterations the chaotic env amplifies any param diff
    # into different trajectories, so multi-iter comparisons are invalid.)
    c_pack, m_pack = _run(pack=True, split=False, iters=1)
    c_leg, m_leg = _run(pack=False, split=False, iters=1)
    for k in (
        "policy_loss", "value_loss", "entropy", "ESS", "action_norm",
        "advantages_mean", "advantages_std", "TP_loss",
    ):
        a, b = float(m_pack[k]), float(m_leg[k])
        assert abs(a - b) < 1e-3 * max(1.0, abs(b)), (k, a, b)
    for a, b in zip(
        jax.tree_util.tree_leaves(
            (c_pack.ts.actor_params, c_pack.ts.critic_params)
        ),
        jax.tree_util.tree_leaves(
            (c_leg.ts.actor_params, c_leg.ts.critic_params)
        ),
    ):
        assert (
            float(jnp.max(jnp.abs(jnp.asarray(a, jnp.float32)
                                  - jnp.asarray(b, jnp.float32)))) < 3e-3
        )


def test_packed_matches_legacy_split_progs():
    c_pack, m_pack = _run(pack=True, split=True, iters=1)
    c_leg, m_leg = _run(pack=False, split=True, iters=1)
    for a, b in zip(
        jax.tree_util.tree_leaves(c_pack.ts.actor_params),
        jax.tree_util.tree_leaves(c_leg.ts.actor_params),
    ):
        assert (
            float(jnp.max(jnp.abs(jnp.asarray(a, jnp.float32)
                                  - jnp.asarray(b, jnp.float32)))) < 3e-3
        )


def test_packed_multi_iter_runs_finite():
    carry, metrics = _run(pack=True, split=True, iters=3)
    assert np.isfinite(float(metrics["policy_loss"]))
    assert np.isfinite(float(metrics["value_loss"]))
    assert np.isfinite(
        float(jnp.max(jnp.abs(jax.tree_util.tree_leaves(
            carry.ts.actor_params)[0])))
    )


def test_pack_meta_layout_roundtrip():
    from mupe_tpu.learning.mappo import compute_pack_meta, pack_rollout_row
    from mupe_tpu.ops.fused_encoder import EncoderSpec, pack_obs

    key = jax.random.PRNGKey(3)
    ks = jax.random.split(key, 6)
    e, n = 6, 3
    obs = {
        "state_self": jax.random.normal(ks[0], (e, n, 1, 35)),
        "state_others": jax.random.normal(ks[1], (e, n, 2, 3)),
        "cylinders": jax.random.normal(ks[2], (e, n, 3, 5)),
    }
    action = jax.random.normal(ks[3], (e, n, 4))
    logp = jax.random.normal(ks[4], (e, n, 1))
    value = jax.random.normal(ks[5], (e, n, 1))
    meta = compute_pack_meta(obs, n, 4)
    rows = pack_rollout_row(meta, obs, action, logp, value)
    assert rows.shape == (e, meta.total)
    # obs columns reshape to the exact pack_obs layout
    spec = EncoderSpec(groups=meta.groups)
    x_ref, _ = pack_obs(spec, obs, list(meta.names))
    x_pack = rows[:, : meta.obs_cols].reshape(e * n, meta.obs_dim)
    np.testing.assert_allclose(np.asarray(x_pack), np.asarray(x_ref), atol=0)
    np.testing.assert_allclose(
        np.asarray(rows[:, meta.off_logp : meta.off_logp + n]),
        np.asarray(logp.reshape(e, n)), atol=0,
    )
    # reserved GAE columns zeroed
    assert float(jnp.abs(rows[:, meta.off_adv :]).max()) == 0.0
