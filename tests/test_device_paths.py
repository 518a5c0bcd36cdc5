"""What the program needs from its platform: the compile-cache location,
the packages the main path imports, the on-card smoke script's refusal to
run without a GPU, and the env-axis sharded training iteration."""
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    """With JAX_COMPILATION_CACHE_DIR set the helper leaves JAX's setting
    alone (JAX reads the variable itself); without it the cache goes to
    <repo>/.jax_cache."""
    from mupe_tpu.utils.compile_cache import REPO_CACHE_DIR, setup_compile_cache

    before = jax.config.jax_compilation_cache_dir
    sentinel = str(tmp_path / "sentinel")
    try:
        jax.config.update("jax_compilation_cache_dir", sentinel)
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
            assert setup_compile_cache() == str(tmp_path / "env")
            assert jax.config.jax_compilation_cache_dir == sentinel
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            assert setup_compile_cache() == str(REPO / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == str(REPO_CACHE_DIR)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


_MAIN_PATH = """
import sys, tempfile
from mupe_tpu.harness import train
common = ["env.num_envs=4", "env.max_episode_length=8", "algo.train_every=8",
          "algo.num_minibatches=2", "algo.ppo_epochs=1", "max_iters=1",
          "log_interval=1", "save_interval=-1"]
with tempfile.TemporaryDirectory() as d:
    train(common + [f"run_dir={d}", "run_name=h"], default_task="Hover")
    train(common + ["env.buffer_length=16", f"run_dir={d}", "run_name=g"],
          default_task="HideAndSeek_envgen")
print("LOADED", sorted({m.split(".")[0] for m in sys.modules} & {"flax", "orbax", "yaml"}))
"""


def test_main_path_imports_no_flax_orbax_yaml():
    """Training Hover and HideAndSeek(+AEG) MAPPO through the entry point
    — checkpoint included — imports none of flax, orbax or yaml."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="")
    proc = subprocess.run(
        [sys.executable, "-c", _MAIN_PATH], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout[-2000:]


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path, where):
    """On the CPU (and, alone in a directory, without the program) the smoke
    script exits non-zero and prints no result line."""
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if where == "alone":
        cwd = tmp_path
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="")
    proc = subprocess.run(
        [sys.executable, str(script)], cwd=str(cwd), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_sharded_train_iter_matches_single_device():
    """The `chip_smoke.py --devices 4` phase at tiny shapes on 4 virtual
    CPU devices: env leaves span the 4 devices and the sharded iteration's
    metrics match the same iteration on one device."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    m_multi, m_one = chip_smoke.multichip_phase(
        jax.devices()[:4], envs_per_device=2,
        overrides=["env.max_episode_length=8", "algo.train_every=8",
                   "algo.num_minibatches=2", "algo.ppo_epochs=1"],
    )
    assert set(m_multi) == set(m_one)
    assert np.isfinite(list(m_multi.values())).all()
