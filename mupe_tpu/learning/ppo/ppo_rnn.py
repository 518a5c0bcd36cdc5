"""Recurrent PPO: GRU cores with episode-boundary masking and BPTT.

Counterpart of omni_drones/learning/ppo/ppo_rnn.py:177-414: actor and critic
share the MLP-encoder → masked-GRU layout; acting threads explicit recurrent
state, and the update reshapes trajectories into `train_seq_len` BPTT chunks
whose initial hidden state is re-zeroed at `is_init` boundaries
(ppo_rnn.py:396-414 `make_batch`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import optax
from flax import linen as nn

from ..gae import compute_gae
from ..mappo import MAPPOCfg
from ..modules.distributions import Gaussian
from ..modules.linen import MLP, DiagGaussianHead
from ..modules.rnn import MaskedGRU
from ..valuenorm import ValueNorm1


@dataclasses.dataclass(frozen=True)
class PPORNNCfg(MAPPOCfg):
    train_seq_len: int = 16
    rnn_hidden: int = 128
    gamma: float = 0.99
    use_tp_net: bool = False


class _RNNCore(nn.Module):
    """Flat encoder → MaskedGRU; one step."""

    rnn_hidden: int

    @nn.compact
    def __call__(self, obs, state, is_init):
        feats = MLP((256, 256))(obs)
        return MaskedGRU(self.rnn_hidden)(feats, state, is_init)


class _RNNActor(nn.Module):
    action_dim: int
    rnn_hidden: int

    @nn.compact
    def __call__(self, obs, state, is_init) -> Tuple[Gaussian, jnp.ndarray]:
        out, new_state = _RNNCore(self.rnn_hidden)(obs, state, is_init)
        return DiagGaussianHead(self.action_dim)(out), new_state


class _RNNCritic(nn.Module):
    rnn_hidden: int

    @nn.compact
    def __call__(self, obs, state, is_init) -> Tuple[jnp.ndarray, jnp.ndarray]:
        out, new_state = _RNNCore(self.rnn_hidden)(obs, state, is_init)
        v = nn.Dense(1, kernel_init=nn.initializers.orthogonal(0.01))(out)
        return v, new_state


class RNNRollout(NamedTuple):
    """Time-major recurrent trajectory batch; rnn states saved per step so
    BPTT chunks can start from stored hidden states."""

    obs: jnp.ndarray          # [T, E, n, D]
    action: jnp.ndarray       # [T, E, n, A]
    logp: jnp.ndarray         # [T, E, n, 1]
    value: jnp.ndarray        # [T, E, n, 1]
    reward: jnp.ndarray       # [T, E, n, 1]
    done: jnp.ndarray         # [T, E, 1]
    is_init: jnp.ndarray      # [T, E, n, 1] — episode started at this step
    actor_rnn: jnp.ndarray    # [T, E, n, H] — state *before* the step
    critic_rnn: jnp.ndarray   # [T, E, n, H]
    last_obs: jnp.ndarray
    last_actor_rnn: jnp.ndarray
    last_critic_rnn: jnp.ndarray
    last_is_init: jnp.ndarray


class PPORNNPolicy:
    """Self-contained recurrent PPO (acting API threads hidden state)."""

    recurrent = True

    def __init__(
        self,
        cfg: PPORNNCfg = PPORNNCfg(),
        n_agents: int = 1,
        action_dim: int = 4,
    ):
        self.cfg = cfg
        self.n_agents = n_agents
        self.action_dim = action_dim
        self.actor = _RNNActor(action_dim, cfg.rnn_hidden)
        self.critic = _RNNCritic(cfg.rnn_hidden)
        tx = lambda lr: optax.chain(
            optax.clip_by_global_norm(cfg.max_grad_norm), optax.adam(lr)
        )
        self.actor_tx = tx(cfg.actor_lr)
        self.critic_tx = tx(cfg.critic_lr)

    def init(self, key: jnp.ndarray, obs_example) -> Dict[str, Any]:
        ka, kc = jax.random.split(key)
        h = self.zero_state(obs_example.shape[:-1])
        ii = jnp.ones(obs_example.shape[:-1] + (1,), bool)
        actor_params = self.actor.init(ka, obs_example, h, ii)
        critic_params = self.critic.init(kc, obs_example, h, ii)
        return {
            "actor_params": actor_params,
            "critic_params": critic_params,
            "actor_opt": self.actor_tx.init(actor_params),
            "critic_opt": self.critic_tx.init(critic_params),
            "value_norm": ValueNorm1.create((1,), beta=self.cfg.value_norm_beta),
        }

    def zero_state(self, batch_shape) -> jnp.ndarray:
        return jnp.zeros(tuple(batch_shape) + (self.cfg.rnn_hidden,))

    def act(
        self, ts, obs, actor_rnn, critic_rnn, is_init, key, deterministic=False
    ):
        dist, new_actor_rnn = self.actor.apply(
            ts["actor_params"], obs, actor_rnn, is_init
        )
        action = dist.mode if deterministic else dist.sample(key)
        logp = dist.log_prob(action)[..., None]
        value, new_critic_rnn = self.critic.apply(
            ts["critic_params"], obs, critic_rnn, is_init
        )
        return action, logp, value, new_actor_rnn, new_critic_rnn

    # ---------------------------------------------------------------- train
    def train_op(self, ts, batch: RNNRollout, key: jnp.ndarray):
        cfg = self.cfg
        t_len, e = batch.reward.shape[:2]
        vn: ValueNorm1 = ts["value_norm"]

        next_value, _ = self.critic.apply(
            ts["critic_params"], batch.last_obs, batch.last_critic_rnn,
            batch.last_is_init,
        )
        values = vn.denormalize(batch.value)
        next_value = vn.denormalize(next_value)
        adv, ret = compute_gae(
            batch.reward, batch.done[..., None, :], values, next_value,
            cfg.gamma, cfg.gae_lambda,
        )
        if cfg.normalize_advantages:
            adv = (adv - jnp.mean(adv)) / (jnp.std(adv) + 1e-8)
        vn = vn.update(ret)
        ret = vn.normalize(ret)
        ts = {**ts, "value_norm": vn}

        # BPTT chunks: [T, E, ...] → [n_seq, L, ...] (ppo_rnn.py:396-414)
        # BPTT chunk length cannot exceed the rollout length
        seq = min(cfg.train_seq_len, t_len)
        n_chunk = t_len // seq

        def chunk(x):  # [T, E, ...] → [n_chunk * E, L, ...]
            x = x[: n_chunk * seq]
            x = x.reshape((n_chunk, seq) + x.shape[1:])
            x = jnp.moveaxis(x, 2, 1)  # [n_chunk, E, L, ...]
            return x.reshape((n_chunk * e,) + x.shape[2:])

        data = {
            "obs": chunk(batch.obs),
            "action": chunk(batch.action),
            "logp": chunk(batch.logp),
            "value": chunk(batch.value),
            "adv": chunk(adv),
            "ret": chunk(ret),
            "is_init": chunk(batch.is_init),
            "actor_rnn0": chunk(batch.actor_rnn)[:, 0],
            "critic_rnn0": chunk(batch.critic_rnn)[:, 0],
        }
        b = n_chunk * e
        mb = max(1, b // cfg.num_minibatches)

        def unroll(apply_fn, params, obs, rnn0, is_init):
            def step(h, inp):
                o, ii = inp
                out, h = apply_fn(params, o, h, ii)
                return h, out

            _, outs = jax.lax.scan(
                step, rnn0, (jnp.swapaxes(obs, 0, 1), jnp.swapaxes(is_init, 0, 1))
            )
            return jnp.swapaxes(
                outs[0] if isinstance(outs, tuple) else outs, 0, 1
            )

        def actor_loss(p, mbatch):
            def step(h, inp):
                o, ii = inp
                dist, h = self.actor.apply(p, o, h, ii)
                return h, (dist.mean, dist.log_std)

            _, (means, log_stds) = jax.lax.scan(
                step,
                mbatch["actor_rnn0"],
                (
                    jnp.swapaxes(mbatch["obs"], 0, 1),
                    jnp.swapaxes(mbatch["is_init"], 0, 1),
                ),
            )
            dist = Gaussian(jnp.swapaxes(means, 0, 1), jnp.swapaxes(log_stds, 0, 1))
            logp_new = dist.log_prob(mbatch["action"])[..., None]
            ratio = jnp.exp(
                jnp.clip(logp_new - mbatch["logp"], -20.0, 20.0)
            )  # inf-ratio guard (see mappo._update_actor)
            surr1 = ratio * mbatch["adv"]
            surr2 = jnp.clip(ratio, 1 - cfg.clip_param, 1 + cfg.clip_param) * mbatch["adv"]
            pl = -jnp.mean(jnp.minimum(surr1, surr2) * self.action_dim)
            ent = -jnp.mean(dist.entropy())
            return pl + cfg.entropy_coef * ent, pl

        def critic_loss(p, mbatch):
            def step(h, inp):
                o, ii = inp
                v, h = self.critic.apply(p, o, h, ii)
                return h, v

            _, vs = jax.lax.scan(
                step,
                mbatch["critic_rnn0"],
                (
                    jnp.swapaxes(mbatch["obs"], 0, 1),
                    jnp.swapaxes(mbatch["is_init"], 0, 1),
                ),
            )
            vs = jnp.swapaxes(vs, 0, 1)
            clipped = mbatch["value"] + jnp.clip(
                vs - mbatch["value"], -cfg.clip_param, cfg.clip_param
            )
            h = lambda a, t: jnp.mean(optax.huber_loss(a, t, cfg.huber_delta))
            return jnp.maximum(h(vs, mbatch["ret"]), h(clipped, mbatch["ret"]))

        def epoch(ts, ek):
            perm = jax.random.permutation(ek, b)[: mb * cfg.num_minibatches]
            idx = perm.reshape(cfg.num_minibatches, mb)

            def mb_step(ts, i):
                mbatch = jax.tree_util.tree_map(lambda x: x[i], data)
                (l, pl), g = jax.value_and_grad(actor_loss, has_aux=True)(
                    ts["actor_params"], mbatch
                )
                up, ao = self.actor_tx.update(g, ts["actor_opt"], ts["actor_params"])
                ap = optax.apply_updates(ts["actor_params"], up)
                cl, gc = jax.value_and_grad(critic_loss)(
                    ts["critic_params"], mbatch
                )
                up2, co = self.critic_tx.update(
                    gc, ts["critic_opt"], ts["critic_params"]
                )
                cp = optax.apply_updates(ts["critic_params"], up2)
                ts = {
                    **ts,
                    "actor_params": ap,
                    "actor_opt": ao,
                    "critic_params": cp,
                    "critic_opt": co,
                }
                return ts, {"policy_loss": pl, "value_loss": cl}

            return jax.lax.scan(mb_step, ts, idx)

        ts, infos = jax.lax.scan(
            epoch, ts, jax.random.split(key, cfg.ppo_epochs)
        )
        return ts, {k: jnp.mean(v) for k, v in infos.items()}
