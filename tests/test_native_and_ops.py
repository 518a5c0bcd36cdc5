"""Native C++ easy-task generator and farthest-point-sampling tests."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mupe_tpu.native import _py_easy_tasks, generate_easy_tasks


def _inside(c, n):
    r = n // 2
    return (c[..., 0] - r) ** 2 + (c[..., 1] - r) ** 2 < r * r


def test_native_easy_tasks_valid():
    tasks = generate_easy_tasks(64, 9, 3, seed=7)
    assert tasks.shape == (64, 4, 2)
    assert _inside(tasks, 9).all()  # all cells inside the arena circle
    # pursuers adjacent-ish to the evader (BFS from it): chebyshev ≤ 2
    target = tasks[:, 3:4]
    d = np.abs(tasks[:, :3] - target).max(-1)
    assert (d <= 2).all()
    # pursuer cells distinct per task
    for t in tasks:
        assert len({tuple(c) for c in t[:3]}) == 3


def test_native_matches_python_semantics():
    """C++ and Python generators agree on structural invariants (not RNG)."""
    a = generate_easy_tasks(32, 9, 3, seed=1)
    b = _py_easy_tasks(32, 9, 3, seed=1)
    for tasks in (a, b):
        assert _inside(tasks, 9).all()
        d = np.abs(tasks[:, :3] - tasks[:, 3:4]).max(-1)
        assert (d <= 2).all()


def _fps_numpy(points, k, valid):
    """Brute-force farthest-point sampling: start at index 0, then k−1
    times take the valid point farthest from everything selected so far."""
    sel = [0]
    for _ in range(1, k):
        d = np.min(
            [np.sum((points - points[i]) ** 2, axis=-1) for i in sel], axis=0
        )
        sel.append(int(np.argmax(np.where(valid, d, -np.inf))))
    return np.asarray(sel)


@pytest.mark.parametrize("masked", [False, True])
def test_fps_matches_numpy_reference(masked):
    from mupe_tpu.ops.fps import farthest_point_sampling

    rng = np.random.default_rng(3)
    pts = rng.normal(size=(128, 16)).astype(np.float32)
    valid = rng.uniform(size=128) < 0.5 if masked else np.ones(128, bool)
    valid[0] = True
    got = np.asarray(
        jax.jit(farthest_point_sampling, static_argnums=1)(
            jnp.asarray(pts), 17, jnp.asarray(valid)
        )
    )
    np.testing.assert_array_equal(got, _fps_numpy(pts, 17, valid))
    assert valid[got].all()


def test_easy_cases_bootstrap_under_jitted_reset():
    """Regression: use_init_easy_cases runs the host-side C++ BFS generator;
    it must be precomputed at env construction, NOT inside `reset`, which
    init_carry jits (a traced reset turned the numpy round-trip into a
    TracerArrayConversionError and killed the AEG evidence run)."""
    import jax
    import numpy as np

    from mupe_tpu.envs.hideandseek_envgen import (
        HideAndSeekEnvgen,
        HideAndSeekEnvgenCfg,
    )

    env = HideAndSeekEnvgen(
        HideAndSeekEnvgenCfg(
            num_envs=4, max_episode_length=16, use_init_easy_cases=True,
            buffer_length=64,
        )
    )
    state = jax.jit(env.reset)(jax.random.PRNGKey(0))
    assert int(state.gen.history_len) == 64
    assert np.all(np.isfinite(np.asarray(state.gen.history)))
