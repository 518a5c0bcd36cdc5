"""Action distributions as pure functions over parameter arrays.

Counterparts of omni_drones/learning/modules/distributions.py: `DiagGaussian`
(:66-82, the MAPPO default), `IndependentNormal` (:139), tanh-squashed normal
(:217), `IndependentBeta` (:148), and multi-categorical (:286-343).  The MAPPO head is
a plain init/apply module producing distribution parameters (its flax
counterpart for the PPO family is `linen.DiagGaussianHead`);
sampling/log-prob/entropy are stateless functions so they can run inside
scans and grad transforms.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


class Gaussian(NamedTuple):
    """Diagonal Gaussian with event dim 1 (torch D.Independent(Normal, 1))."""

    mean: jnp.ndarray
    log_std: jnp.ndarray

    @property
    def std(self) -> jnp.ndarray:
        return jnp.exp(self.log_std)

    def sample(self, key: jnp.ndarray) -> jnp.ndarray:
        return self.mean + self.std * jax.random.normal(
            key, self.mean.shape, self.mean.dtype
        )

    @property
    def mode(self) -> jnp.ndarray:
        return self.mean

    def log_prob(self, value: jnp.ndarray) -> jnp.ndarray:
        z = (value - self.mean) / self.std
        per_dim = -0.5 * jnp.square(z) - self.log_std - _LOG_SQRT_2PI
        return jnp.sum(per_dim, axis=-1)

    def entropy(self) -> jnp.ndarray:
        per_dim = self.log_std + 0.5 * (1.0 + math.log(2.0 * math.pi))
        return jnp.sum(jnp.broadcast_to(per_dim, self.mean.shape), axis=-1)


@dataclasses.dataclass(frozen=True)
class DiagGaussianHead:
    """Linear mean + state-independent log-std (distributions.py:66-82).

    Mean weights initialized xavier-uniform with gain 0.01, zero bias,
    log_std starts at 0 — matching the reference's `init_` + zeros.
    Float32 throughout: action log-probs feed the PPO importance ratios.
    """

    action_dim: int
    gain: float = 0.01

    def init(self, key, x):
        return {"params": self.params(key, x.shape[-1])}

    def apply(self, variables, x) -> Gaussian:
        return self.forward(variables["params"], x)

    def params(self, key, in_dim: int):
        # xavier_uniform with gain g ⇒ scale = g² · (fan_avg variance 1)
        init = jax.nn.initializers.variance_scaling(self.gain**2, "fan_avg", "uniform")
        return {
            "Dense_0": {
                "kernel": init(key, (in_dim, self.action_dim), jnp.float32),
                "bias": jnp.zeros((self.action_dim,), jnp.float32),
            },
            "log_std": jnp.zeros((self.action_dim,), jnp.float32),
        }

    def forward(self, p, x) -> Gaussian:
        d = p["Dense_0"]
        mean = jnp.dot(x.astype(jnp.float32), d["kernel"]) + d["bias"]
        return Gaussian(mean=mean, log_std=jnp.broadcast_to(p["log_std"], mean.shape))


class TanhGaussian(NamedTuple):
    """Tanh-squashed diagonal Gaussian (distributions.py:217 TanhIndependentNormal)."""

    mean: jnp.ndarray
    log_std: jnp.ndarray

    def sample(self, key: jnp.ndarray) -> jnp.ndarray:
        pre = self.mean + jnp.exp(self.log_std) * jax.random.normal(
            key, self.mean.shape, self.mean.dtype
        )
        return jnp.tanh(pre)

    @property
    def mode(self) -> jnp.ndarray:
        return jnp.tanh(self.mean)

    def log_prob(self, value: jnp.ndarray) -> jnp.ndarray:
        eps = 1e-6
        pre = jnp.arctanh(jnp.clip(value, -1.0 + eps, 1.0 - eps))
        base = Gaussian(self.mean, self.log_std).log_prob(pre)
        correction = jnp.sum(
            jnp.log(1.0 - jnp.square(jnp.tanh(pre)) + eps), axis=-1
        )
        return base - correction


class Beta(NamedTuple):
    """Independent Beta on [min, max] (distributions.py:148-214)."""

    alpha: jnp.ndarray
    beta: jnp.ndarray
    low: float = 0.0
    high: float = 1.0

    def sample(self, key: jnp.ndarray) -> jnp.ndarray:
        x = jax.random.beta(key, self.alpha, self.beta)
        return x * (self.high - self.low) + self.low

    @property
    def mode(self) -> jnp.ndarray:
        m = (self.alpha - 1.0) / (self.alpha + self.beta - 2.0)
        return m * (self.high - self.low) + self.low

    def log_prob(self, value: jnp.ndarray) -> jnp.ndarray:
        x = jnp.clip((value - self.low) / (self.high - self.low), 1e-6, 1 - 1e-6)
        lp = (
            (self.alpha - 1.0) * jnp.log(x)
            + (self.beta - 1.0) * jnp.log1p(-x)
            - (
                jax.scipy.special.gammaln(self.alpha)
                + jax.scipy.special.gammaln(self.beta)
                - jax.scipy.special.gammaln(self.alpha + self.beta)
            )
        ) - math.log(self.high - self.low)
        return jnp.sum(lp, axis=-1)


class MultiCategorical(NamedTuple):
    """Independent categoricals over concatenated logit groups
    (distributions.py:286-343)."""

    logits: Sequence[jnp.ndarray]  # tuple of (..., n_i)

    def sample(self, key: jnp.ndarray) -> jnp.ndarray:
        keys = jax.random.split(key, len(self.logits))
        return jnp.stack(
            [jax.random.categorical(k, l) for k, l in zip(keys, self.logits)],
            axis=-1,
        )

    @property
    def mode(self) -> jnp.ndarray:
        return jnp.stack([jnp.argmax(l, axis=-1) for l in self.logits], axis=-1)

    def log_prob(self, value: jnp.ndarray) -> jnp.ndarray:
        lps = []
        for i, l in enumerate(self.logits):
            logp = jax.nn.log_softmax(l, axis=-1)
            lps.append(
                jnp.take_along_axis(logp, value[..., i : i + 1], axis=-1)[..., 0]
            )
        return sum(lps)

    def entropy(self) -> jnp.ndarray:
        ent = 0.0
        for l in self.logits:
            p = jax.nn.softmax(l, axis=-1)
            ent = ent + (-jnp.sum(p * jax.nn.log_softmax(l, axis=-1), axis=-1))
        return ent


class TwoHot(NamedTuple):
    """Two-hot discretized scalar distribution over fixed support
    (distributions.py:384-427): a categorical whose mean interpolates
    between adjacent bins; log_prob targets are two-hot encodings."""

    logits: jnp.ndarray            # (..., n_bins)
    low: float = -20.0
    high: float = 20.0

    @property
    def support(self) -> jnp.ndarray:
        return jnp.linspace(self.low, self.high, self.logits.shape[-1])

    @property
    def mean(self) -> jnp.ndarray:
        probs = jax.nn.softmax(self.logits, axis=-1)
        return jnp.sum(probs * self.support, axis=-1, keepdims=True)

    @property
    def mode(self) -> jnp.ndarray:
        return self.mean

    def log_prob(self, value: jnp.ndarray) -> jnp.ndarray:
        """Cross-entropy against the two-hot encoding of `value` (..., 1)."""
        support = self.support
        n = support.shape[0]
        v = jnp.clip(value[..., 0], self.low, self.high)
        idx = jnp.clip(
            jnp.searchsorted(support, v, side="right") - 1, 0, n - 2
        )
        lo, hi = support[idx], support[idx + 1]
        w_hi = (v - lo) / (hi - lo)
        logp = jax.nn.log_softmax(self.logits, axis=-1)
        lp_lo = jnp.take_along_axis(logp, idx[..., None], axis=-1)[..., 0]
        lp_hi = jnp.take_along_axis(logp, idx[..., None] + 1, axis=-1)[..., 0]
        return (1.0 - w_hi) * lp_lo + w_hi * lp_hi
