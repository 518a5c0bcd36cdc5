"""End-to-end vision path: Hover depth observations → ppo_vision policy.

Covers the sensors/depth.py → transforms.obs.depth_image_norm →
MixedObsEncoder chain the reference only ships as disconnected pieces
(camera is viz-only there, sensors/camera.py:40; MixedEncoder untrained,
networks.py:322-368)."""
import jax
import jax.numpy as jnp
import numpy as np

from mupe_tpu.envs.hover import Hover, HoverCfg
from mupe_tpu.learning import init_carry, make_train_iter
from mupe_tpu.learning.registry import make_policy


def _env(n=8):
    return Hover(
        HoverCfg(
            num_envs=n, max_episode_length=32,
            obs_depth=True, depth_width=16, depth_height=12,
        )
    )


def test_hover_depth_obs_shape_and_range():
    env = _env()
    state = env.reset(jax.random.PRNGKey(0))
    obs = env.observe(state)
    assert set(obs.keys()) == {"observation", "depth"}
    assert obs["depth"].shape == (8, 1, 12, 16, 1)
    d = np.asarray(obs["depth"])
    assert np.all(d >= 0.0) and np.all(d <= 1.0)
    # the ground plane must appear: downward-looking pixels see finite
    # depth (> 0 after normalization) somewhere in the frame
    assert float(d.max()) > 0.0


def test_depth_sees_target_sphere():
    """A camera aimed straight at the target renders it closer (higher
    normalized value) than the same scene without the target."""
    from mupe_tpu.sensors.depth import DepthCameraCfg, depth_image
    from mupe_tpu.transforms.obs import depth_image_norm

    cam = DepthCameraCfg(width=16, height=12, max_range=8.0)
    pos = jnp.asarray([[0.0, 0.0, 1.0]])
    quat = jnp.asarray([[1.0, 0.0, 0.0, 0.0]])  # identity: +x forward
    tgt = jnp.asarray([[2.0, 0.0, 1.0]])
    with_t = depth_image_norm(
        depth_image(cam, pos, quat, target_pos=tgt, target_radius=0.25),
        cam.min_range, cam.max_range,
    )
    without = depth_image_norm(
        depth_image(cam, pos, quat), cam.min_range, cam.max_range
    )
    assert float(jnp.max(with_t - without)) > 0.1


def test_ppo_vision_trains():
    env = _env()
    policy = make_policy(
        "ppo_vision", env, {"train_every": 8, "num_minibatches": 2}
    )
    carry = init_carry(env, policy, jax.random.PRNGKey(0))
    it = jax.jit(make_train_iter(env, policy))
    for _ in range(2):
        carry, metrics, stats = it(carry)
    assert np.isfinite(float(metrics["policy_loss"]))
    assert np.isfinite(float(metrics["value_loss"]))
    # gradient actually reached the conv vision branch
    leaf = jax.tree_util.tree_leaves(carry.ts.actor_params)
    assert all(np.all(np.isfinite(np.asarray(l))) for l in leaf)


def test_ppo_vision_from_harness():
    """scripts/train.py dispatch: task=Hover algo=ppo_vision e2e."""
    from mupe_tpu.harness import build

    env, policy, env_cfg, algo_cfg = build(
        "Hover",
        {"num_envs": 4, "max_episode_length": 16, "obs_depth": True,
         "depth_width": 16, "depth_height": 12},
        {"train_every": 4, "num_minibatches": 1},
        algo="ppo_vision",
    )
    carry = init_carry(env, policy, jax.random.PRNGKey(1))
    it = jax.jit(make_train_iter(env, policy))
    carry, metrics, _ = it(carry)
    assert np.isfinite(float(metrics["policy_loss"]))


def test_mobilenet_v3_small_shapes_and_grads():
    """The JAX MobileNetV3-Small backbone (reference
    networks.py:371-428): 576-dim features from 1- or 3-channel frames,
    gradients flow to every block."""
    from mupe_tpu.learning.modules.mobilenet import MobileNetV3

    net = MobileNetV3(variant="small")
    x1 = jax.random.normal(jax.random.PRNGKey(0), (2, 3, 48, 64, 1))
    params = net.init(jax.random.PRNGKey(1), x1)
    y = net.apply(params, x1)
    assert y.shape == (2, 3, 576)
    assert np.isfinite(np.asarray(y)).all()
    # 3-channel input uses the same params (1-ch is repeated to 3)
    x3 = jax.random.normal(jax.random.PRNGKey(2), (4, 48, 64, 3))
    y3 = net.apply(params, x3)
    assert y3.shape == (4, 576)

    g = jax.grad(lambda p: jnp.sum(jnp.square(net.apply(p, x3))))(params)
    norms = [float(jnp.linalg.norm(l)) for l in jax.tree_util.tree_leaves(g)]
    assert sum(n > 0 for n in norms) >= 0.9 * len(norms)


def test_mobilenet_batchstats_norm_is_stateless():
    """track_running_stats=False semantics: pure function, same output for
    same input, batch-statistic normalization (unit variance-ish)."""
    from mupe_tpu.learning.modules.mobilenet import _BatchStatsNorm

    bn = _BatchStatsNorm()
    x = jax.random.normal(jax.random.PRNGKey(0), (64, 4, 4, 8)) * 5 + 3
    p = bn.init(jax.random.PRNGKey(1), x)
    y = bn.apply(p, x)
    yf = np.asarray(y).reshape(-1, 8)
    np.testing.assert_allclose(yf.mean(0), 0.0, atol=1e-3)
    np.testing.assert_allclose(yf.std(0), 1.0, atol=1e-2)
    np.testing.assert_array_equal(np.asarray(bn.apply(p, x)), np.asarray(y))


def test_ppo_vision_mobilenet_trains():
    """ppo_vision with the MobileNetV3-Small backbone end-to-end."""
    env = _env()
    policy = make_policy(
        "ppo_vision", env,
        {"train_every": 8, "num_minibatches": 2, "ppo_epochs": 1,
         "vision_encoder": "mobilenet_v3_small"},
    )
    carry = init_carry(env, policy, jax.random.PRNGKey(0))
    train_iter = jax.jit(make_train_iter(env, policy))
    carry, metrics, stats = train_iter(carry)
    assert np.isfinite(float(metrics["policy_loss"]))
    assert np.isfinite(float(metrics["value_loss"]))
