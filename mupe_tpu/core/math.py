"""Small tensor-math helpers shared across layers (pure jax.numpy).

Counterparts of omni_drones/utils/torch.py:40-57,130,261-268.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_HIGHEST = jax.lax.Precision.HIGHEST


def matmul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """`a @ b` at full float32 precision.

    The controllers' 3×3 and 4×4 products must not run in TF32 (about three
    decimal digits), which is what a GPU's default float32 precision
    allows; on the CPU the result is unchanged."""
    return jnp.matmul(a, b, precision=_HIGHEST)


def einsum(subscripts: str, *operands: jnp.ndarray) -> jnp.ndarray:
    """`jnp.einsum` at full float32 precision (see `matmul`)."""
    return jnp.einsum(subscripts, *operands, precision=_HIGHEST)


def off_diag(a: jnp.ndarray) -> jnp.ndarray:
    """Drop the diagonal of an (n, n, ...) pairwise tensor → (n, n-1, ...).

    Matches omni_drones/utils/torch.py:40-47 (`off_diag`).
    """
    n = a.shape[0]
    return (
        a.reshape((n * n,) + a.shape[2:])[1:]
        .reshape((n - 1, n + 1) + a.shape[2:])[:, :-1]
        .reshape((n, n - 1) + a.shape[2:])
    )


def cpos(p1: jnp.ndarray, p2: jnp.ndarray) -> jnp.ndarray:
    """Pairwise relative positions p1[i] - p2[j] → (n1, n2, d).

    Matches omni_drones/utils/torch.py:50-52 (`cpos`).
    """
    return p1[:, None, :] - p2[None, :, :]


def normalize(x: jnp.ndarray, eps: float = 1e-6) -> jnp.ndarray:
    return x / (jnp.linalg.norm(x, axis=-1, keepdims=True) + eps)


def symlog(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.sign(x) * jnp.log(jnp.abs(x) + 1.0)


def symexp(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.sign(x) * (jnp.exp(jnp.abs(x)) - 1.0)
