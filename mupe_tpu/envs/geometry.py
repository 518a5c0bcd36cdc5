"""Arena geometry: line-of-sight blocking and k-nearest-cylinder gathers.

Counterparts of the reference geometry helpers
(omni_drones/envs/hide_and_seek/hideandseek.py:47-103 LoS blocking,
:755-778 k-nearest-cylinder observation).  These are the per-step hot
[env × agent × cylinder] ops, implemented as pure jnp that XLA fuses.
"""
from __future__ import annotations

from typing import Tuple

import jax.lax
import jax.numpy as jnp


def line_blocked_by_cylinder(
    drone_pos: jnp.ndarray,     # [E, n, 3]
    target_pos: jnp.ndarray,    # [E, 1, 3]
    cylinder_pos: jnp.ndarray,  # [E, C, 3]
    cylinder_size: float,
) -> jnp.ndarray:
    """Whether any grounded cylinder blocks the drone↔target segment in XY.

    Matches hideandseek.py:67-103 (`is_line_blocked_by_cylinder` +
    `is_perpendicular_line_intersecting_segment`): a cylinder blocks iff
    its XY distance to the segment's supporting line ≤ radius, its foot of
    perpendicular lies within the segment, and it stands on the ground
    (z > 0).  Returns bool [E, n].
    """
    diff = drone_pos - target_pos                 # [E, n, 3]
    diff2 = cylinder_pos - target_pos             # [E, C, 3]
    # cross-product magnitude in XY → distance of cylinder to the line
    num = jnp.abs(
        diff[..., :, None, 0] * diff2[..., None, :, 1]
        - diff[..., :, None, 1] * diff2[..., None, :, 0]
    )                                             # [E, n, C]
    denom = jnp.sqrt(
        jnp.square(diff[..., :, None, 0]) + jnp.square(diff[..., :, None, 1])
    )
    dist_to_line = num / (denom + 1e-5)
    blocked = dist_to_line <= cylinder_size

    # foot of perpendicular within the segment (hideandseek.py:47-65)
    # NOTE: the reference parameterizes the segment from the *drone* (a) to
    # the target (b) with direction b − a and projects c − a onto it.
    dx = target_pos[..., 0] - drone_pos[..., 0]   # [E, n]
    dy = target_pos[..., 1] - drone_pos[..., 1]
    num_t = (
        (cylinder_pos[..., None, :, 0] - drone_pos[..., :, None, 0]) * dx[..., :, None]
        + (cylinder_pos[..., None, :, 1] - drone_pos[..., :, None, 1]) * dy[..., :, None]
    )
    denom_t = jnp.square(dx)[..., :, None] + jnp.square(dy)[..., :, None]
    t = num_t / (denom_t + 1e-5)
    on_segment = (t >= 0.0) & (t <= 1.0)

    on_ground = (cylinder_pos[..., 2] > 0.0)[..., None, :]  # [E, 1, C]
    return jnp.any(blocked & on_segment & on_ground, axis=-1)


def k_nearest_cylinders(
    drone_pos: jnp.ndarray,     # [E, n, 3]
    cylinder_pos: jnp.ndarray,  # [E, C, 3]
    cylinder_size: float,
    cylinder_height: float,
    k: int,
    mask_value: float = -5.0,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-drone k-nearest cylinder features (hideandseek.py:755-778).

    Returns:
        masked:  [E, n, k, 5] — [rpos(3), height, radius], inactive→mask_value
        raw:     [E, n, k, 5] — same gather without masking (used by the
                 collision reward, hideandseek.py:962-969)
        invalid: [E, n, k] bool — gathered inactive mask
    """
    e, n, _ = drone_pos.shape
    c = cylinder_pos.shape[1]
    rpos = cylinder_pos[:, None, :, :] - drone_pos[:, :, None, :]  # [E, n, C, 3]
    feat = jnp.concatenate(
        [
            rpos,
            jnp.full((e, n, c, 1), cylinder_height, drone_pos.dtype),
            jnp.full((e, n, c, 1), cylinder_size, drone_pos.dtype),
        ],
        axis=-1,
    )
    inactive = cylinder_pos[..., 2] < 0.0                          # [E, C]
    mdist = jnp.linalg.norm(rpos, axis=-1) - cylinder_size         # [E, n, C]

    # Selection WITHOUT top_k/gather at these tiny shapes ([E,n,5]→k=3):
    # rank each cylinder by pairwise comparison (ties broken by index, which
    # reproduces top_k's stable order) and select with a one-hot sum — pure
    # elementwise + reduce over C, fully fused by XLA.
    di = mdist[..., :, None]                                       # [E,n,C,1]
    dj = mdist[..., None, :]                                       # [E,n,1,C]
    lt = (dj < di) | ((dj == di) & (jnp.arange(c)[:, None] > jnp.arange(c)[None, :]))
    rank = jnp.sum(lt, axis=-1)                                    # [E,n,C]
    onehot = rank[..., None, :] == jnp.arange(k)[:, None]          # [E,n,k,C]
    sel = onehot.astype(feat.dtype)
    raw = jnp.sum(sel[..., None] * feat[..., None, :, :], axis=-2)  # [E,n,k,5]
    invalid = jnp.any(onehot & inactive[:, None, None, :], axis=-1)  # [E,n,k]
    masked = jnp.where(invalid[..., None], mask_value, raw)
    return masked, raw, invalid
