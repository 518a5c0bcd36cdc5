"""Reference trajectories and spatial sampling utilities.

Counterparts of the reference's misc utils (SURVEY §2.4):
- lemniscate / zigzag / circle reference trajectories
  (omni_drones/envs/utils/__init__.py:175-321), used by tracking tasks;
- B-spline trajectory evaluation (omni_drones/utils/bspline.py, torch splev);
- Poisson-disk sampling (omni_drones/utils/poisson_disk.py:29) for
  collision-free spawn layouts.

All pure jnp/numpy, statically shaped.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.math import matmul


def lemniscate(t: jnp.ndarray, c: float = 0.0) -> jnp.ndarray:
    """Figure-eight reference (envs/utils/__init__.py lemniscate): the
    Bernoulli lemniscate in xy with optional vertical modulation c·sin(t)."""
    sin_t, cos_t = jnp.sin(t), jnp.cos(t)
    denom = 1.0 + jnp.square(sin_t)
    x = cos_t / denom
    y = sin_t * cos_t / denom
    z = c * sin_t
    return jnp.stack([x, y, z], axis=-1)


def circle(t: jnp.ndarray, radius: float = 1.0, omega: float = 1.0) -> jnp.ndarray:
    return jnp.stack(
        [radius * jnp.cos(omega * t), radius * jnp.sin(omega * t),
         jnp.zeros_like(t)],
        axis=-1,
    )


def zigzag(t: jnp.ndarray, period: float = 2.0, amplitude: float = 1.0) -> jnp.ndarray:
    """Triangle-wave lateral reference (envs/utils/__init__.py zigzag)."""
    phase = (t / period) % 1.0
    tri = 2.0 * jnp.abs(2.0 * phase - 1.0) - 1.0
    return jnp.stack(
        [t * 0.2, amplitude * tri, jnp.zeros_like(t)], axis=-1
    )


def bspline_eval(
    control_points: jnp.ndarray,  # [K, D]
    knots: jnp.ndarray,           # [K + degree + 1]
    t: jnp.ndarray,               # [T] query parameters
    degree: int = 3,
) -> jnp.ndarray:
    """De Boor evaluation of a clamped B-spline (utils/bspline.py splev).

    Vectorized Cox–de Boor recursion with static degree; O(K·degree) per
    query point, fully jittable.
    """
    k = control_points.shape[0]

    def basis(t_q):
        # zeroth order
        n = ((knots[:-1] <= t_q) & (t_q < knots[1:])).astype(control_points.dtype)
        # right-edge inclusion for the final knot
        n = n.at[-1].set(jnp.where(t_q >= knots[-1], 1.0, n[-1]))
        for d in range(1, degree + 1):
            left_num = t_q - knots[: -(d + 1)]
            left_den = knots[d:-1] - knots[: -(d + 1)]
            right_num = knots[d + 1 :] - t_q
            right_den = knots[d + 1 :] - knots[1:-d]
            left = jnp.where(left_den > 1e-9, left_num / left_den, 0.0) * n[:-1]
            right = jnp.where(right_den > 1e-9, right_num / right_den, 0.0) * n[1:]
            n = left + right
        return n[:k]

    b = jax.vmap(basis)(t)  # [T, K]
    return matmul(b, control_points)


def poisson_disk_sample(
    key: jnp.ndarray,
    num_points: int,
    bounds: Tuple[float, float],
    min_dist: float,
    num_candidates: int = 30,
) -> jnp.ndarray:
    """Bounded-iteration Mitchell's best-candidate approximation of
    Poisson-disk sampling (utils/poisson_disk.py:29): each new point is the
    candidate farthest from the existing set, giving blue-noise spacing
    without data-dependent rejection loops.  → [num_points, 2]
    """
    lo, hi = bounds

    def body(carry, k):
        pts, count = carry
        cand = jax.random.uniform(
            k, (num_candidates, 2), minval=lo, maxval=hi
        )
        d = jnp.linalg.norm(
            cand[:, None, :] - pts[None, :, :], axis=-1
        )  # [C, N]
        mask = jnp.arange(pts.shape[0]) < count
        dmin = jnp.min(jnp.where(mask[None, :], d, jnp.inf), axis=-1)
        best = jnp.argmax(jnp.minimum(dmin, 2.0 * min_dist))
        pts = pts.at[count].set(cand[best])
        return (pts, count + 1), None

    init = jnp.zeros((num_points, 2))
    k0, krest = jax.random.split(key)
    init = init.at[0].set(
        jax.random.uniform(k0, (2,), minval=lo, maxval=hi)
    )
    (pts, _), _ = jax.lax.scan(
        body, (init, jnp.asarray(1)), jax.random.split(krest, num_points - 1)
    )
    return pts
