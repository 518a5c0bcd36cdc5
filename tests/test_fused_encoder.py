"""The packed-row encoder math (ops/fused_encoder.py) vs the functional
modules, the flax formulation and a float32 reference."""
import jax
import jax.numpy as jnp
import optax
import pytest

from mupe_tpu.learning.mappo import Actor, Critic
from mupe_tpu.ops.fused_encoder import (
    EncoderSpec,
    extract_leaves,
    pack_obs,
    reference_apply,
)

NAMES = ["state_self", "cylinders", "state_others"]  # entity_group_order


def _setup(s=96):
    key = jax.random.PRNGKey(0)
    ks = jax.random.split(key, 4)
    obs = {
        "state_self": jax.random.normal(ks[0], (s, 1, 35)),
        "state_others": jax.random.normal(ks[1], (s, 2, 3)),
        "cylinders": jax.random.normal(ks[2], (s, 3, 5)),
    }
    groups = tuple((obs[n].shape[-2], obs[n].shape[-1]) for n in NAMES)
    spec = EncoderSpec(groups=groups)
    return spec, obs, ks[3]


def _actor(dtype=jnp.bfloat16):
    return Actor(
        action_dim=4, hidden_units=(256,),
        attn_encoder="PartialAttentionEncoder", obs_is_dict=True, dtype=dtype,
    )


def _critic(dtype=jnp.bfloat16):
    return Critic(
        out_dim=1, hidden_units=(256,),
        attn_encoder="PartialAttentionEncoder", obs_is_dict=True, dtype=dtype,
    )


def test_reference_matches_flax_actor():
    pytest.importorskip("flax")
    import flax_witness

    spec, obs, k = _setup()
    actor = flax_witness.Actor(
        action_dim=4, hidden_units=(256,), obs_is_dict=True, dtype=jnp.bfloat16
    )
    p = actor.init(k, obs)
    leaves = extract_leaves(p, NAMES)
    x, lead = pack_obs(spec, obs, NAMES)
    ref = reference_apply(spec, leaves, x).reshape(lead + (4,))
    fl = actor.apply(p, obs).mean
    scale = float(jnp.max(jnp.abs(fl))) + 1e-6
    assert float(jnp.max(jnp.abs(ref - fl))) / scale < 0.05
    # the functional Actor runs the same math on the obs dict
    fn = _actor().apply(p, obs).mean
    assert float(jnp.max(jnp.abs(fn - ref))) < 1e-5


def test_reference_matches_flax_critic():
    pytest.importorskip("flax")
    import flax_witness

    spec, obs, k = _setup()
    critic = flax_witness.Critic(
        out_dim=1, hidden_units=(256,), obs_is_dict=True, dtype=jnp.bfloat16
    )
    p = critic.init(k, obs)
    leaves = extract_leaves(p, NAMES)
    x, lead = pack_obs(spec, obs, NAMES)
    ref = reference_apply(spec, leaves, x).reshape(lead + (1,))
    fl = critic.apply(p, obs)
    scale = float(jnp.max(jnp.abs(fl))) + 1e-6
    assert float(jnp.max(jnp.abs(ref - fl))) / scale < 0.05
    fn = _critic().apply(p, obs)
    assert float(jnp.max(jnp.abs(fn - ref))) < 1e-5


@pytest.mark.parametrize(
    "which,obs_is_dict",
    [("actor", True), ("critic", True), ("actor", False), ("critic", False)],
)
def test_functional_init_tree_matches_flax(which, obs_is_dict):
    """Functional init builds the flax param tree: same paths, same shapes
    (checkpoints, extract_leaves and the .../log_std accesses rely on it)."""
    pytest.importorskip("flax")
    import flax_witness

    if obs_is_dict:
        _, obs, k = _setup(s=4)
    else:
        obs, k = jnp.zeros((4, 2, 21)), jax.random.PRNGKey(3)
    hidden = (64, 32)
    if which == "actor":
        fn = Actor(4, hidden, "PartialAttentionEncoder", obs_is_dict, jnp.bfloat16)
        fl = flax_witness.Actor(4, hidden, obs_is_dict, jnp.bfloat16)
    else:
        fn = Critic(1, hidden, "PartialAttentionEncoder", obs_is_dict, jnp.bfloat16)
        fl = flax_witness.Critic(1, hidden, obs_is_dict, jnp.bfloat16)
    p_fn, p_fl = fn.init(k, obs), fl.init(k, obs)

    def shapes(t):
        return jax.tree_util.tree_map(lambda x: (x.shape, x.dtype), t)

    assert shapes(p_fn) == shapes(p_fl)
    # flax params run through the functional apply and vice versa
    out_fn = fn.apply(p_fl, obs)
    out_fl = fl.apply(p_fl, obs)
    if which == "actor":
        out_fn, out_fl = out_fn.mean, out_fl.mean
    assert out_fn.shape == out_fl.shape
    scale = float(jnp.max(jnp.abs(out_fl))) + 1e-6
    assert float(jnp.max(jnp.abs(out_fn - out_fl))) / scale < 0.05


def test_encoder_grads_match_float32_reference():
    """bf16-trunk gradients of a policy-style loss vs the same network in
    float32 at `highest` matmul precision: relative norm error per leaf
    within bf16's ~3 significant digits accumulated over 6 matmuls.  The
    key bias gets no gradient analytically (softmax is shift-invariant),
    so each leaf also gets an absolute floor of 1e-3 of the whole
    gradient's norm."""
    spec, obs, k = _setup(s=256)
    p = _actor().init(k, obs)
    x, _ = pack_obs(spec, obs, NAMES)
    tgt = jax.random.normal(jax.random.PRNGKey(7), (x.shape[0], 4))

    def loss(params, sp):
        out = reference_apply(sp, extract_leaves(params, NAMES), x)
        return jnp.mean(jnp.square(out - tgt))

    g_bf16 = jax.grad(loss)(p, spec)
    with jax.default_matmul_precision("highest"):
        g_f32 = jax.grad(loss)(p, EncoderSpec(spec.groups, dtype="float32"))
    total = float(optax.global_norm(g_f32))
    for a, b in zip(jax.tree_util.tree_leaves(g_bf16), jax.tree_util.tree_leaves(g_f32)):
        err = float(jnp.linalg.norm(a - b))
        assert err <= 0.05 * float(jnp.linalg.norm(b)) + 1e-3 * total


def test_pair_custom_vjp_cpu_fallback():
    """Actor and critic over the same packed rows: grads land in both
    param trees and equal autodiff through the functional modules."""
    spec, obs, k = _setup()
    pa = _actor().init(k, obs)
    pc = _critic().init(jax.random.PRNGKey(5), obs)
    x, _ = pack_obs(spec, obs, NAMES)

    def loss(params):
        out_a = reference_apply(spec, extract_leaves(params[0], NAMES), x)
        out_c = reference_apply(spec, extract_leaves(params[1], NAMES), x)
        return jnp.sum(jnp.square(out_a)) + jnp.sum(jnp.square(out_c))

    def loss_modules(params):
        mean = _actor().apply(params[0], obs).mean
        value = _critic().apply(params[1], obs)
        return jnp.sum(jnp.square(mean)) + jnp.sum(jnp.square(value))

    ga, gc = jax.grad(loss)((pa, pc))
    for g in (ga, gc):
        norms = [float(jnp.linalg.norm(l)) for l in jax.tree_util.tree_leaves(g)]
        assert sum(n > 0 for n in norms) >= len(norms) - 1
    gm = jax.grad(loss_modules)((pa, pc))
    for a, b in zip(jax.tree_util.tree_leaves((ga, gc)), jax.tree_util.tree_leaves(gm)):
        assert float(jnp.max(jnp.abs(a - b))) <= 1e-5 * (1.0 + float(jnp.max(jnp.abs(b))))


def test_custom_vjp_grads_flow_into_flax_tree():
    """jax.grad through extract_leaves + reference_apply lands in the
    param tree."""
    spec, obs, k = _setup()
    p = _actor().init(k, obs)
    x, _ = pack_obs(spec, obs, NAMES)

    def loss(params):
        leaves = extract_leaves(params, NAMES)
        return jnp.sum(jnp.square(reference_apply(spec, leaves, x)))

    g = jax.grad(loss)(p)
    flat = jax.tree_util.tree_leaves(g)
    norms = [float(jnp.linalg.norm(l)) for l in flat]
    # every encoder/head weight receives gradient except log_std (unused)
    assert sum(n > 0 for n in norms) >= len(norms) - 1
