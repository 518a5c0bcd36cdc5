#!/usr/bin/env python
"""Drone zoo demo: spawn each model and hold hover for 1 s
(reference: examples/demo_drone.py)."""
import jax.numpy as jnp

from mupe_tpu.dynamics import DRONE_ZOO, hover_state, make_params, step


def main():
    for name in DRONE_ZOO:
        params = make_params(name)
        pos = jnp.asarray([[[0.0, 0.0, 1.0]]])
        quat = jnp.asarray([[[1.0, 0.0, 0.0, 0.0]]])
        state = hover_state(params, pos, quat)
        h = params.hover_throttle
        cmds = jnp.full((1, 1, params.num_rotors), 2.0 * h**2 - 1.0)
        for _ in range(100):
            state, _ = step(params, state, cmds, 0.01)
        drift = float(jnp.linalg.norm(state.pos - pos))
        print(f"{name:18s} rotors={params.num_rotors:2d} "
              f"mass={float(params.mass):7.4f} kg  1s-hover drift={drift:.4f} m")


if __name__ == "__main__":
    main()
