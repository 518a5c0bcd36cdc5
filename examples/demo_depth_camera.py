#!/usr/bin/env python
"""Depth-camera demo: render an onboard depth image of a HideAndSeek-style
scene as ASCII art (reference: sensors/camera.py viz path; here the
analytic JAX renderer, mupe_tpu/sensors/depth.py).

Runs on CPU; no simulator needed.
"""
import jax.numpy as jnp

from mupe_tpu.core import euler_to_quaternion
from mupe_tpu.sensors import DepthCameraCfg, depth_image


def main():
    cfg = DepthCameraCfg(width=72, height=24, max_range=3.0)
    # camera at one side of the arena, level, looking across
    cam_pos = jnp.asarray([-0.7, 0.0, 0.6])
    cam_quat = euler_to_quaternion(jnp.asarray([0.0, 0.15, 0.0]))
    cylinders = jnp.asarray(
        [
            [0.0, 0.0, 0.6],
            [0.3, 0.35, 0.6],
            [-0.2, -0.4, 0.6],
            [0.5, -0.15, 0.6],
            [0.0, 0.0, -20.0],  # parked/inactive
        ]
    )
    img = depth_image(
        cfg,
        cam_pos,
        cam_quat,
        cylinders=cylinders,
        cylinder_size=0.1,
        arena_size=0.9,
        max_height=1.2,
        target_pos=jnp.asarray([0.45, 0.25, 0.6]),
        target_radius=0.075,
    )
    shades = " .:-=+*#%@"
    norm = 1.0 - (img - cfg.min_range) / (cfg.max_range - cfg.min_range)
    idx = jnp.clip((norm * (len(shades) - 1)).astype(int), 0, len(shades) - 1)
    print(f"depth {cfg.width}x{cfg.height}  (near=@, far=space)")
    for row in idx:
        print("".join(shades[int(i)] for i in row))


if __name__ == "__main__":
    main()
