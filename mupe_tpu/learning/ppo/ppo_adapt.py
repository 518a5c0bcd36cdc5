"""RMA-style adaptive PPO: privileged intrinsics encoder + adaptation module.

Counterpart of omni_drones/learning/ppo/ppo_adapt.py:144-666
(`PPOAdaptivePolicy`): three training phases
  * "encoder"    — PPO with a privileged context  z = E(intrinsics);
  * "adaptation" — freeze the policy; train a TConv module A(obs history)
                   to reproduce z (losses: MSE on z, action-distribution
                   divergence, value deviation — ppo_adapt.py:454-617);
  * "finetune"   — act from  ẑ = A(history)  and finetune the policy.
Conditioning is concat or FiLM (ppo_adapt.py:131,178-181).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import optax
from flax import linen as nn

from ..mappo import MAPPOCfg, MAPPOPolicy
from ..modules.distributions import Gaussian
from ..modules.linen import MLP, DiagGaussianHead
from .ppo_tconv import TConvEncoder


@dataclasses.dataclass(frozen=True)
class PPOAdaptCfg(MAPPOCfg):
    phase: str = "encoder"        # encoder | adaptation | finetune
    context_dim: int = 64
    condition_mode: str = "cat"   # cat | film
    # mse | action | value | action_value | gan | lsgan
    # (ppo_adapt.py:454 MSE, :545 ActionDistDiv, :581 ValueDeviation,
    #  :617 ActionValue, :481 GAN, :520 LSGAN)
    adaptation_loss: str = "mse"
    adaptation_lr: float = 3e-4
    gamma: float = 0.99
    use_tp_net: bool = False


class IntrinsicsEncoder(nn.Module):
    """LayerNorm → MLP[64,64] → context (ppo_adapt.py, the `encoder` branch)."""

    context_dim: int = 64

    @nn.compact
    def __call__(self, intrinsics: jnp.ndarray) -> jnp.ndarray:
        return MLP((64, self.context_dim))(nn.LayerNorm()(intrinsics))


class AdaptationModule(nn.Module):
    """TConv over the obs history → predicted context (ppo_adapt.py TConv
    adaptation module)."""

    context_dim: int = 64

    @nn.compact
    def __call__(self, obs_history: jnp.ndarray) -> jnp.ndarray:
        return nn.Dense(self.context_dim)(TConvEncoder()(obs_history))


class _CondBody(nn.Module):
    """Obs features conditioned on a context, by concat or FiLM."""

    condition_mode: str = "cat"

    @nn.compact
    def __call__(self, obs: jnp.ndarray, context: jnp.ndarray) -> jnp.ndarray:
        feats = MLP((128, 128))(obs)
        if self.condition_mode == "film":
            gamma = nn.Dense(feats.shape[-1])(context)
            beta = nn.Dense(feats.shape[-1])(context)
            x = feats * (1.0 + gamma) + beta
        else:
            x = jnp.concatenate([feats, context], axis=-1)
        return MLP((256, 256))(x)


class _AdaptActor(nn.Module):
    action_dim: int
    condition_mode: str

    @nn.compact
    def __call__(self, obs, context) -> Gaussian:
        return DiagGaussianHead(self.action_dim)(
            _CondBody(self.condition_mode)(obs, context)
        )


class _AdaptCritic(nn.Module):
    condition_mode: str

    @nn.compact
    def __call__(self, obs, context) -> jnp.ndarray:
        return nn.Dense(1, kernel_init=nn.initializers.orthogonal(0.01))(
            _CondBody(self.condition_mode)(obs, context)
        )


class ContextDiscriminator(nn.Module):
    """Context → real/fake logit, for the GAN/LSGAN adaptation variants
    (ppo_adapt.py:481-520: `discriminator` producing a "label")."""

    @nn.compact
    def __call__(self, context: jnp.ndarray) -> jnp.ndarray:
        return nn.Dense(1)(MLP((64, 64))(context))[..., 0]


def gaussian_kl(p: Gaussian, q: Gaussian) -> jnp.ndarray:
    """KL(p ‖ q) for diagonal Gaussians, summed over the event dim
    (torch D.kl_divergence in ppo_adapt.py:566)."""
    var_ratio = jnp.exp(2.0 * (p.log_std - q.log_std))
    t = jnp.square((p.mean - q.mean) / q.std)
    return 0.5 * jnp.sum(var_ratio + t - 1.0 - jnp.log(var_ratio), axis=-1)


class _ContextActorWrapper(nn.Module):
    """Adapts the (obs dict) → Gaussian interface expected by MAPPOPolicy:
    context comes from intrinsics (encoder/finetune phases use different
    sources at act time, chosen by the policy)."""

    action_dim: int
    condition_mode: str
    context_dim: int
    use_adaptation: bool

    @nn.compact
    def __call__(self, obs: Dict[str, jnp.ndarray]) -> Gaussian:
        if self.use_adaptation:
            context = AdaptationModule(self.context_dim, name="adaptation")(
                obs["observation_h"]
            )
        else:
            context = IntrinsicsEncoder(self.context_dim, name="encoder")(
                obs["intrinsics"]
            )
        return _AdaptActor(self.action_dim, self.condition_mode)(
            obs["observation"], context
        )


class _ContextCriticWrapper(nn.Module):
    condition_mode: str
    context_dim: int

    @nn.compact
    def __call__(self, obs: Dict[str, jnp.ndarray]) -> jnp.ndarray:
        context = IntrinsicsEncoder(self.context_dim, name="encoder")(
            obs["intrinsics"]
        )
        return _AdaptCritic(self.condition_mode)(obs["observation"], context)


class PPOAdaptivePolicy(MAPPOPolicy):
    """Observations: {"observation": flat, "intrinsics": flat,
    "observation_h": (..., T, D) history} (the History transform provides
    observation_h).  PPO machinery is inherited; the adaptation phase adds
    `update_adaptation`."""

    def __init__(
        self,
        cfg: PPOAdaptCfg = PPOAdaptCfg(),
        n_agents: int = 1,
        action_dim: int = 4,
    ):
        self.adapt_cfg = cfg
        use_adaptation = cfg.phase in ("adaptation", "finetune")
        super().__init__(
            cfg,
            n_agents=n_agents,
            action_dim=action_dim,
            obs_is_dict=True,
            actor_module=_ContextActorWrapper(
                action_dim, cfg.condition_mode, cfg.context_dim, use_adaptation
            ),
            critic_module=_ContextCriticWrapper(cfg.condition_mode, cfg.context_dim),
        )
        self.encoder = IntrinsicsEncoder(cfg.context_dim)
        self.adaptation = AdaptationModule(cfg.context_dim)
        self.actor_body = _AdaptActor(action_dim, cfg.condition_mode)
        self.critic_body = _AdaptCritic(cfg.condition_mode)
        self.discriminator = ContextDiscriminator()
        self.adapt_tx = optax.adam(cfg.adaptation_lr)
        self.disc_tx = optax.adam(5e-4)  # ppo_adapt.py:493

    @staticmethod
    def body_params(wrapper_params, scope: str):
        """Extract a sub-module's params from a wrapper's param tree (flax
        names anonymous submodules `<Class>_0`)."""
        return {"params": wrapper_params["params"][scope]}

    def update_adaptation(
        self,
        adaptation_params,
        adapt_opt,
        encoder_params,
        obs_history: jnp.ndarray,
        intrinsics: jnp.ndarray,
        obs: jnp.ndarray | None = None,
        actor_params=None,
        critic_params=None,
        disc_params=None,
        disc_opt=None,
    ) -> Tuple[dict, dict, jnp.ndarray]:
        """Phase-2 supervised step: make Â(history) act like E(intrinsics).

        Loss variants (cfg.adaptation_loss):
          * mse           — ‖ẑ − z‖²                       (ppo_adapt.py:454-479)
          * action        — KL(π(·|o,ẑ) ‖ π(·|o,z))        (:545-580 ActionDistDiv)
          * value         — ‖V(o,ẑ) − V(o,z)‖²             (:581-616 ValueDeviation)
          * action_value  — both                            (:617-666 ActionValue)
          * gan / lsgan   — discriminator on contexts       (:481-543)
        Actor/critic/discriminator weights are never updated here (the
        reference's `hold_out_net`): the gradient flows only to the
        adaptation module, plus a separate discriminator step for GANs.
        """
        variant = self.adapt_cfg.adaptation_loss
        z = jax.lax.stop_gradient(self.encoder.apply(encoder_params, intrinsics))

        def pred_ctx(p):
            return self.adaptation.apply(p, obs_history)

        if variant == "mse":
            def loss_fn(p):
                return jnp.mean(jnp.square(pred_ctx(p) - z))
        elif variant == "action":
            target = self.actor_body.apply(actor_params, obs, z)
            def loss_fn(p):
                pred = self.actor_body.apply(actor_params, obs, pred_ctx(p))
                return jnp.mean(gaussian_kl(pred, jax.lax.stop_gradient(target)))
        elif variant == "value":
            target = self.critic_body.apply(critic_params, obs, z)
            def loss_fn(p):
                pred = self.critic_body.apply(critic_params, obs, pred_ctx(p))
                return jnp.mean(
                    jnp.square(pred - jax.lax.stop_gradient(target))
                )
        elif variant == "action_value":
            a_target = self.actor_body.apply(actor_params, obs, z)
            v_target = self.critic_body.apply(critic_params, obs, z)
            def loss_fn(p):
                ctx = pred_ctx(p)
                a_pred = self.actor_body.apply(actor_params, obs, ctx)
                v_pred = self.critic_body.apply(critic_params, obs, ctx)
                return jnp.mean(
                    gaussian_kl(a_pred, jax.lax.stop_gradient(a_target))
                ) + jnp.mean(
                    jnp.square(v_pred - jax.lax.stop_gradient(v_target))
                )
        elif variant in ("gan", "lsgan"):
            return self._update_gan(
                adaptation_params, adapt_opt, z, obs_history,
                disc_params, disc_opt, least_squares=(variant == "lsgan"),
            )
        else:
            raise ValueError(f"unknown adaptation_loss {variant!r}")

        loss, grads = jax.value_and_grad(loss_fn)(adaptation_params)
        updates, adapt_opt = self.adapt_tx.update(grads, adapt_opt, adaptation_params)
        adaptation_params = optax.apply_updates(adaptation_params, updates)
        return adaptation_params, adapt_opt, loss

    def _update_gan(
        self, adaptation_params, adapt_opt, z, obs_history,
        disc_params, disc_opt, least_squares: bool,
    ):
        """One generator + one discriminator step (ppo_adapt.py:481-543).
        Returns (adaptation_params, adapt_opt, loss_g, disc_params, disc_opt,
        loss_d)."""
        bce = lambda logit, y: jnp.mean(
            optax.sigmoid_binary_cross_entropy(logit, jnp.full_like(logit, y))
        )
        z_fake = jax.lax.stop_gradient(
            self.adaptation.apply(adaptation_params, obs_history)
        )

        def d_loss_fn(dp):
            real = self.discriminator.apply(dp, z)
            fake = self.discriminator.apply(dp, z_fake)
            if least_squares:  # LSGAN (:537-541): real→1, fake→−1
                return jnp.mean(jnp.square(real - 1.0)) + jnp.mean(
                    jnp.square(fake + 1.0)
                )
            return 0.5 * (bce(real, 1.0) + bce(fake, 0.0))

        loss_d, d_grads = jax.value_and_grad(d_loss_fn)(disc_params)
        d_updates, disc_opt = self.disc_tx.update(d_grads, disc_opt, disc_params)
        disc_params = optax.apply_updates(disc_params, d_updates)

        def g_loss_fn(p):
            fake = self.discriminator.apply(
                disc_params, self.adaptation.apply(p, obs_history)
            )
            if least_squares:
                return jnp.mean(jnp.square(fake - 1.0))
            return bce(fake, 1.0)

        loss_g, g_grads = jax.value_and_grad(g_loss_fn)(adaptation_params)
        g_updates, adapt_opt = self.adapt_tx.update(
            g_grads, adapt_opt, adaptation_params
        )
        adaptation_params = optax.apply_updates(adaptation_params, g_updates)
        return adaptation_params, adapt_opt, loss_g, disc_params, disc_opt, loss_d
