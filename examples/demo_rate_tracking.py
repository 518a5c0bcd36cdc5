#!/usr/bin/env python
"""PID body-rate controller tracking demo
(reference: examples/test_att_controller.py): command a roll-rate setpoint
and print the tracking response."""
import jax.numpy as jnp
import numpy as np

from mupe_tpu.controllers import PIDRateState, pid_rate_control
from mupe_tpu.dynamics import hover_state, make_params, step


def main():
    params = make_params("crazyflie")
    state = hover_state(
        params, jnp.asarray([[[0.0, 0.0, 1.0]]]),
        jnp.asarray([[[1.0, 0.0, 0.0, 0.0]]]),
    )
    pid = PIDRateState.zeros((1, 1))
    target = jnp.asarray([[[45.0, 0.0, 0.0]]])  # deg/s roll
    thrust = jnp.full((1, 1, 1), float(params.hover_throttle) * 2**16)
    print("t[s]  roll_rate[deg/s] (target 45)")
    for i in range(120):
        cmds, _, pid = pid_rate_control(
            state.drone_quat if hasattr(state, 'drone_quat') else state.quat,
            state.angvel, target, thrust, pid, 0.01,
        )
        state, _ = step(params, state, cmds, 0.01)
        if i % 20 == 19:
            rate = float(state.body_rate[0, 0, 0]) * 180.0 / np.pi
            print(f"{(i+1)*0.01:4.2f}  {rate:8.2f}")


if __name__ == "__main__":
    main()
