"""Value normalizers as explicit pytree states.

Counterparts of omni_drones/learning/utils/valuenorm.py: `ValueNorm1`
(:41-103, EMA with debiasing — the MAPPO default with β=0.995) and
`ValueNorm2` (:106-162, Welford running moments).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core import struct


@struct.dataclass
class ValueNorm1:
    """Debiased EMA normalizer (valuenorm.py:41-103)."""

    running_mean: jnp.ndarray
    running_mean_sq: jnp.ndarray
    debiasing_term: jnp.ndarray
    beta: float = struct.field(pytree_node=False, default=0.995)
    epsilon: float = struct.field(pytree_node=False, default=1e-5)

    @classmethod
    def create(cls, shape=(1,), beta: float = 0.995) -> "ValueNorm1":
        return cls(
            running_mean=jnp.zeros(shape),
            running_mean_sq=jnp.zeros(shape),
            debiasing_term=jnp.zeros(()),
            beta=beta,
        )

    def _mean_var(self):
        d = jnp.clip(self.debiasing_term, self.epsilon, None)
        mean = self.running_mean / d
        mean_sq = self.running_mean_sq / d
        var = jnp.clip(mean_sq - jnp.square(mean), 1e-2, None)
        return mean, var

    def update(self, batch: jnp.ndarray) -> "ValueNorm1":
        ndim = self.running_mean.ndim
        axes = tuple(range(batch.ndim - ndim))
        batch_mean = jnp.mean(batch, axis=axes)
        batch_sq = jnp.mean(jnp.square(batch), axis=axes)
        w = self.beta
        return self.replace(
            running_mean=self.running_mean * w + batch_mean * (1 - w),
            running_mean_sq=self.running_mean_sq * w + batch_sq * (1 - w),
            debiasing_term=self.debiasing_term * w + (1 - w),
        )

    def normalize(self, x: jnp.ndarray) -> jnp.ndarray:
        mean, var = self._mean_var()
        return (x - mean) / jnp.sqrt(var)

    def denormalize(self, x: jnp.ndarray) -> jnp.ndarray:
        mean, var = self._mean_var()
        return x * jnp.sqrt(var) + mean


@struct.dataclass
class ValueNorm2:
    """Welford running-moment normalizer (valuenorm.py:106-162)."""

    running_mean: jnp.ndarray
    running_var: jnp.ndarray
    count: jnp.ndarray
    subtract_mean: bool = struct.field(pytree_node=False, default=True)

    @classmethod
    def create(cls, shape=(1,), subtract_mean: bool = True) -> "ValueNorm2":
        return cls(
            running_mean=jnp.zeros(shape),
            running_var=jnp.ones(shape),
            count=jnp.zeros(()),
            subtract_mean=subtract_mean,
        )

    def update(self, batch: jnp.ndarray) -> "ValueNorm2":
        ndim = self.running_mean.ndim
        axes = tuple(range(batch.ndim - ndim))
        batch_mean = jnp.mean(batch, axis=axes)
        batch_var = jnp.var(batch, axis=axes, ddof=1)
        batch_count = jnp.asarray(
            jnp.prod(jnp.asarray(batch.shape[: batch.ndim - ndim])), jnp.float32
        )
        delta = batch_mean - self.running_mean
        total = self.count + batch_count
        new_mean = self.running_mean + delta * batch_count / total
        m_a = self.running_var * self.count
        m_b = batch_var * batch_count
        m2 = m_a + m_b + jnp.square(delta) * self.count * batch_count / total
        return self.replace(
            running_mean=new_mean, running_var=m2 / total, count=total
        )

    def normalize(self, x: jnp.ndarray) -> jnp.ndarray:
        eps = jnp.finfo(jnp.float32).eps
        if self.subtract_mean:
            return (x - self.running_mean) / jnp.sqrt(self.running_var + eps)
        return x / jnp.sqrt(self.running_var + eps)

    def denormalize(self, x: jnp.ndarray) -> jnp.ndarray:
        if self.subtract_mean:
            return x * jnp.sqrt(self.running_var) + self.running_mean
        return x * jnp.sqrt(self.running_var)
