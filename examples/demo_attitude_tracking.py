#!/usr/bin/env python
"""Attitude-controller tracking demo: command a sequence of roll/pitch
setpoints and report tracking error (reference:
examples/test_att_controller.py — interactive Isaac demo; here a headless
closed-loop run on the pure-JAX dynamics).

Runs on CPU; no simulator needed.
"""
import jax
import jax.numpy as jnp

from mupe_tpu.controllers import attitude_control, make_mixer
from mupe_tpu.core import quaternion_to_euler
from mupe_tpu.dynamics import hover_state, make_params, step


def main():
    params = make_params("crazyflie")
    mixer = make_mixer("crazyflie")
    pos = jnp.asarray([[[0.0, 0.0, 1.0]]])
    quat = jnp.asarray([[[1.0, 0.0, 0.0, 0.0]]])
    state = hover_state(params, pos, quat)

    dt = 0.01
    setpoints = [
        (0.0, 0.0),
        (0.15, 0.0),
        (0.0, 0.15),
        (-0.15, -0.15),
        (0.0, 0.0),
    ]
    hover_thrust = float(params.mass * params.gravity)

    @jax.jit
    def run_1s(state, roll, pitch):
        def body(state, _):
            cmds = attitude_control(
                mixer,
                state.quat,
                state.angvel,
                target_thrust=jnp.full((1, 1, 1), hover_thrust),
                target_yaw_rate=jnp.zeros((1, 1, 1)),
                target_roll=jnp.full((1, 1, 1), roll),
                target_pitch=jnp.full((1, 1, 1), pitch),
            )
            state, _ = step(params, state, cmds, dt)
            return state, None

        state, _ = jax.lax.scan(body, state, None, length=100)
        return state

    print("target_rp          achieved_rp            err[rad]")
    for roll, pitch in setpoints:
        state = run_1s(state, roll, pitch)
        rpy = quaternion_to_euler(state.quat)[0, 0]
        err = float(jnp.linalg.norm(rpy[:2] - jnp.asarray([roll, pitch])))
        print(
            f"({roll:+.2f},{pitch:+.2f})      "
            f"({float(rpy[0]):+.3f},{float(rpy[1]):+.3f})      {err:.4f}"
        )


if __name__ == "__main__":
    main()
