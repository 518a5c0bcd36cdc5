"""Test harness: run everything on a virtual 8-device CPU mesh.

Multi-device sharding is validated without accelerators by forcing the
host platform to expose 8 XLA CPU devices (the standard JAX fake-mesh CI
pattern).  Must run before jax is imported anywhere.
"""
import os
import pathlib

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# persistent compilation cache inside the checkout (.gitignore lists it):
# the first full run pays the compiles, repeat runs hit the cache
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    str(pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"),
)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# the programmatic override wins over any platform plugin's registration
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

def pytest_sessionstart(session):
    assert jax.device_count() == 8, jax.devices()
