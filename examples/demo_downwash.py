#!/usr/bin/env python
"""Downwash demo: 4 drones hovering in a vertical column; print the
downwash force each one receives (reference: examples/demo_downwash.py).

Runs on CPU; no simulator needed.
"""
import jax.numpy as jnp

from mupe_tpu.dynamics import downwash_forces, hover_state, make_params, step


def main():
    params = make_params("crazyflie")
    heights = jnp.asarray([2.0, 1.5, 1.0, 0.5])
    pos = jnp.stack(
        [jnp.zeros(4), jnp.zeros(4), heights], axis=-1
    )[None]  # [1, 4, 3]
    quat = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0, 0.0]), (1, 4, 4))
    state = hover_state(params, pos, quat)

    thrust_w = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, float(params.gravity)]), (1, 4, 3)
    )
    f = downwash_forces(state.pos, thrust_w)
    print("drone  height  downwash_z [N]")
    for i in range(4):
        print(f"  {i}     {float(heights[i]):.1f}    {float(f[0, i, 2]):+.6f}")

    # hold hover command for 100 ticks and watch the column sag
    h = params.hover_throttle
    cmds = jnp.full((1, 4, 4), 2.0 * h**2 - 1.0)
    for _ in range(100):
        state, _ = step(params, state, cmds, 0.01)
    print("\nheights after 1 s of hover commands (lower drones sag from wake):")
    print(" ", [round(float(z), 3) for z in state.pos[0, :, 2]])


if __name__ == "__main__":
    main()
