"""Learning-layer tests: GAE golden values, value norm, distributions,
MAPPO shapes, and the TP window supervision."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mupe_tpu.learning import ValueNorm1, ValueNorm2, compute_gae
from mupe_tpu.learning.modules.distributions import DiagGaussianHead, Gaussian
from mupe_tpu.learning.modules.networks import (
    PartialAttentionEncoder,
    FlatEncoder,
)


def reference_gae(reward, done, value, next_value, gamma, lmbda):
    """Direct transcription of the reference loop (gae.py:54-74)."""
    not_done = 1.0 - done.astype(np.float32)
    t_len = reward.shape[0]
    gae = np.zeros_like(next_value)
    adv = np.zeros_like(reward)
    nv = next_value
    for step in reversed(range(t_len)):
        delta = reward[step] + gamma * nv * not_done[step] - value[step]
        gae = delta + gamma * lmbda * not_done[step] * gae
        adv[step] = gae
        nv = value[step]
    return adv, adv + value


def test_gae_matches_reference_loop():
    rng = np.random.default_rng(0)
    t, n, k = 12, 5, 1
    reward = rng.normal(size=(t, n, k)).astype(np.float32)
    done = (rng.uniform(size=(t, n, 1)) < 0.2).astype(np.float32)
    value = rng.normal(size=(t, n, k)).astype(np.float32)
    next_value = rng.normal(size=(n, k)).astype(np.float32)
    adv, ret = compute_gae(
        jnp.asarray(reward), jnp.asarray(done), jnp.asarray(value),
        jnp.asarray(next_value), gamma=0.995, lmbda=0.95,
    )
    ref_adv, ref_ret = reference_gae(reward, done, value, next_value, 0.995, 0.95)
    np.testing.assert_allclose(np.asarray(adv), ref_adv, atol=1e-4)
    np.testing.assert_allclose(np.asarray(ret), ref_ret, atol=1e-4)


def test_gae_associative_matches_sequential_scan():
    """The parallel-prefix GAE equals the sequential lax.scan form at the
    production shape (T=64) with episode boundaries."""
    from mupe_tpu.learning.gae import compute_gae_scan

    rng = np.random.default_rng(3)
    t, n, k = 64, 32, 3
    reward = jnp.asarray(rng.normal(size=(t, n, k)).astype(np.float32))
    done = jnp.asarray((rng.uniform(size=(t, n, 1)) < 0.1).astype(np.float32))
    value = jnp.asarray(rng.normal(size=(t, n, k)).astype(np.float32))
    next_value = jnp.asarray(rng.normal(size=(n, k)).astype(np.float32))
    a1, r1 = compute_gae(reward, done, value, next_value, 0.995, 0.95)
    a2, r2 = compute_gae_scan(reward, done, value, next_value, 0.995, 0.95)
    np.testing.assert_allclose(np.asarray(a1), np.asarray(a2), atol=2e-4)
    np.testing.assert_allclose(np.asarray(r1), np.asarray(r2), atol=2e-4)


def test_valuenorm1_round_trip():
    vn = ValueNorm1.create((1,), beta=0.9)
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(5.0, 3.0, size=(1000, 1)).astype(np.float32))
    for _ in range(20):
        vn = vn.update(x)
    y = vn.normalize(x)
    assert abs(float(jnp.mean(y))) < 0.2
    np.testing.assert_allclose(np.asarray(vn.denormalize(y)), np.asarray(x), atol=1e-3)


def test_valuenorm2_welford():
    vn = ValueNorm2.create((1,))
    rng = np.random.default_rng(2)
    xs = rng.normal(2.0, 4.0, size=(10, 500, 1)).astype(np.float32)
    for x in xs:
        vn = vn.update(jnp.asarray(x))
    np.testing.assert_allclose(float(vn.running_mean[0]), xs.mean(), atol=0.05)
    np.testing.assert_allclose(
        float(jnp.sqrt(vn.running_var)[0]), xs.std(), rtol=0.05
    )


def test_gaussian_log_prob_matches_scipy():
    from scipy import stats as sstats

    mean = jnp.asarray([[0.5, -1.0]])
    log_std = jnp.asarray([[0.1, -0.3]])
    g = Gaussian(mean, log_std)
    x = jnp.asarray([[0.2, 0.4]])
    expected = sstats.norm.logpdf(
        np.asarray(x), np.asarray(mean), np.exp(np.asarray(log_std))
    ).sum(-1)
    np.testing.assert_allclose(np.asarray(g.log_prob(x)), expected, atol=1e-5)
    # entropy of indep gaussians
    expected_ent = (np.asarray(log_std) + 0.5 * np.log(2 * np.pi * np.e)).sum(-1)
    np.testing.assert_allclose(np.asarray(g.entropy()), expected_ent, atol=1e-5)


def test_attention_encoder_shapes():
    enc = PartialAttentionEncoder()
    obs = {
        "state_self": jnp.zeros((7, 3, 1, 35)),
        "state_others": jnp.zeros((7, 3, 2, 3)),
        "cylinders": jnp.zeros((7, 3, 3, 5)),
    }
    params = enc.init(jax.random.PRNGKey(0), obs)
    out = enc.apply(params, obs)
    assert out.shape == (7, 3, 128)


def test_flat_encoder_shapes():
    enc = FlatEncoder((64, 32))
    x = jnp.zeros((5, 1, 20))
    params = enc.init(jax.random.PRNGKey(0), x)
    assert enc.apply(params, x).shape == (5, 1, 32)


def test_diag_gaussian_head_init_small_mean():
    head = DiagGaussianHead(action_dim=4)
    params = head.init(jax.random.PRNGKey(0), jnp.ones((3, 128)))
    dist = head.apply(params, jnp.ones((3, 128)))
    # gain 0.01 ⇒ near-zero initial means, unit std
    assert float(jnp.abs(dist.mean).max()) < 0.1
    np.testing.assert_allclose(np.asarray(dist.std), 1.0, atol=1e-6)


def test_mappo_end_to_end_tiny():
    """One fused train iteration on the Hover env: finite losses, changed params."""
    from mupe_tpu.envs.hover import Hover, HoverCfg
    from mupe_tpu.learning import (
        MAPPOCfg,
        MAPPOPolicy,
        init_carry,
        make_train_iter,
    )

    env = Hover(HoverCfg(num_envs=8, max_episode_length=16))
    cfg = MAPPOCfg(
        train_every=8, num_minibatches=2, ppo_epochs=1, hidden_units=(32, 32)
    )
    policy = MAPPOPolicy(cfg, n_agents=1, action_dim=4, obs_is_dict=False)
    carry = init_carry(env, policy, jax.random.PRNGKey(0))
    before = jax.tree_util.tree_leaves(carry.ts.actor_params)[0].copy()
    train_iter = jax.jit(make_train_iter(env, policy))
    carry, metrics, stats = train_iter(carry)
    assert np.isfinite(float(metrics["policy_loss"]))
    assert np.isfinite(float(metrics["value_loss"]))
    after = jax.tree_util.tree_leaves(carry.ts.actor_params)[0]
    assert not np.allclose(np.asarray(before), np.asarray(after))


def test_tp_net_shapes_and_range():
    from mupe_tpu.learning import TPNet

    net = TPNet(output_dim=15)
    x = jnp.ones((4, 10, 13))
    params = net.init(jax.random.PRNGKey(0), x)
    y = net.apply(params, x)
    assert y.shape == (4, 15)
    assert float(jnp.abs(y).max()) <= 1.0


def test_split_train_iter_matches_interface():
    """Split rollout/update programs run and update params like the fused."""
    from mupe_tpu.envs.hover import Hover, HoverCfg
    from mupe_tpu.learning import (
        MAPPOCfg,
        MAPPOPolicy,
        init_carry,
        make_split_train_iter,
    )

    env = Hover(HoverCfg(num_envs=8, max_episode_length=16))
    cfg = MAPPOCfg(
        train_every=8, num_minibatches=2, ppo_epochs=1, hidden_units=(32, 32)
    )
    policy = MAPPOPolicy(cfg, n_agents=1, action_dim=4, obs_is_dict=False)
    carry = init_carry(env, policy, jax.random.PRNGKey(0))
    train_iter = make_split_train_iter(env, policy)
    before = jax.tree_util.tree_leaves(carry.ts.actor_params)[0].copy()
    carry, metrics, stats = train_iter(carry)
    carry, metrics, stats = train_iter(carry)
    assert np.isfinite(float(metrics["policy_loss"]))
    after = jax.tree_util.tree_leaves(carry.ts.actor_params)[0]
    assert not np.allclose(np.asarray(before), np.asarray(after))
    assert "episode_count" in stats


def test_encoder_dict_order_invariance():
    """The attention query must be the state_self token regardless of dict
    insertion order (JAX pytree round-trips sort dict keys)."""
    import jax
    import jax.numpy as jnp
    from mupe_tpu.learning.modules.networks import (
        PartialAttentionEncoder,
        entity_group_order,
    )

    assert entity_group_order(["cylinders", "state_others", "state_self"]) == [
        "state_self", "cylinders", "state_others",
    ]
    enc = PartialAttentionEncoder()
    a = {
        "state_self": jnp.ones((2, 1, 35)),
        "state_others": jnp.zeros((2, 2, 3)),
        "cylinders": jnp.full((2, 3, 5), -5.0),
    }
    b = {k: a[k] for k in sorted(a)}  # pytree-style sorted insertion order
    p = enc.init(jax.random.PRNGKey(0), a)
    out_a = enc.apply(p, a)
    out_b = enc.apply(p, b)
    assert jnp.allclose(out_a, out_b)
    # and the query actually responds to state_self: perturb it
    # (non-uniformly — LayerNorm is invariant to input scaling at zero bias)
    a2 = dict(a)
    a2["state_self"] = a["state_self"] + jnp.arange(35.0)
    assert not jnp.allclose(enc.apply(p, a2), out_a)


def test_tp_net_fused_input_proj_matches_rnn_path():
    """The functional TPNet (one [B*T,F]x[F,4H] input projection + unrolled
    recurrence) must reproduce flax's nn.RNN(OptimizedLSTMCell) on the SAME
    param tree."""
    pytest.importorskip("flax")
    import flax_witness
    from mupe_tpu.learning.tp_net import TPNet

    ref = flax_witness.TPNet(output_dim=15)
    fast = TPNet(output_dim=15)
    x = jax.random.normal(jax.random.PRNGKey(0), (32, 10, 16))
    p_ref = ref.init(jax.random.PRNGKey(1), x)
    p_fast = fast.init(jax.random.PRNGKey(1), x)
    # identical tree structure and shapes (checkpoint compatibility)
    shapes = lambda t: jax.tree_util.tree_map(jnp.shape, t)
    assert shapes(p_ref) == shapes(p_fast)
    y_ref = ref.apply(p_ref, x)
    y_fast = fast.apply(p_ref, x)  # NOTE: flax params through the fast path
    assert float(jnp.max(jnp.abs(y_ref - y_fast))) < 2e-2  # bf16 noise
    # gradients flow through every leaf on the fast path
    g = jax.grad(lambda p: jnp.sum(jnp.square(fast.apply(p, x))))(p_ref)
    norms = [float(jnp.linalg.norm(l)) for l in jax.tree_util.tree_leaves(g)]
    assert all(n > 0 for n in norms)


def test_traj_ring_buffer_extend_wrap_and_sample():
    """TrajRingBuffer (reference MyBuffer, common.py:42-81): ring extend
    over the time axis, contiguous sub-trajectory sampling."""
    from mupe_tpu.learning.mybuffer import TrajRingBuffer, extend, sample, size

    e = 4
    example = {"obs": jnp.zeros((e, 3)), "r": jnp.zeros((e, 1))}
    buf = TrajRingBuffer.create(example, capacity=10)
    assert int(size(buf)) == 0

    # two extends of 4 steps: rows 0..7, cursor 8, len 8
    def chunk(t0, t):
        steps = (t0 + jnp.arange(t)).astype(jnp.float32)
        return {
            "obs": jnp.broadcast_to(steps[:, None, None], (t, e, 3)).copy(),
            "r": jnp.broadcast_to(steps[:, None, None], (t, e, 1)).copy(),
        }

    buf = extend(buf, chunk(0, 4))
    buf = extend(buf, chunk(4, 4))
    assert int(size(buf)) == 8 and int(buf.cursor) == 8
    # wrap: 4 more steps -> rows 8,9,0,1
    buf = extend(buf, chunk(8, 4))
    assert int(size(buf)) == 10 and int(buf.cursor) == 2
    np.testing.assert_allclose(np.asarray(buf.storage["obs"][0, 0]), 10.0)
    np.testing.assert_allclose(np.asarray(buf.storage["obs"][9, 0]), 9.0)

    batch, ok = jax.jit(sample, static_argnums=(2, 3))(
        buf, jax.random.PRNGKey(0), 16, 5
    )
    assert ok.shape == (16,) and bool(ok.all())
    assert batch["obs"].shape == (16, 5, 3)
    # windows are contiguous in CHRONOLOGICAL time: the buffer holds
    # steps 2..11 (steps 10,11 wrapped onto rows 0,1), so every sampled
    # window must be 5 consecutive increasing timesteps — a window that
    # stitched the newest write onto the oldest row across the ring seam
    # (e.g. 11,2,3,4,5) would fail here (round-4 advisor, low).
    o = np.asarray(batch["obs"])[:, :, 0]
    for b in range(16):
        np.testing.assert_allclose(np.diff(o[b]), 1.0, err_msg=str(o[b]))
        assert 2.0 <= o[b, 0] and o[b, -1] <= 11.0, o[b]

    # under-filled buffer flags invalid, per-sample mask shape [B]
    buf2 = TrajRingBuffer.create(example, capacity=10)
    buf2 = extend(buf2, chunk(0, 3))
    _, ok2 = sample(buf2, jax.random.PRNGKey(1), 4, 5)
    assert ok2.shape == (4,) and not bool(ok2.any())

    # pre-wrap buffer: plain prefix, windows still chronological
    batch3, ok3 = sample(buf2, jax.random.PRNGKey(2), 4, 2)
    assert bool(ok3.all())
    o3 = np.asarray(batch3["obs"])[:, :, 0]
    for b in range(4):
        np.testing.assert_allclose(np.diff(o3[b]), 1.0)
        assert 0.0 <= o3[b, 0] and o3[b, -1] <= 2.0
