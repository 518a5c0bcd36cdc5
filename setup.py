from setuptools import find_packages, setup

setup(
    name="mupe_tpu",
    version="0.1.0",
    description="Multi-UAV pursuit-evasion RL framework in JAX (XLA)",
    packages=find_packages(include=["mupe_tpu*"]),
    python_requires=">=3.10",
    install_requires=["jax", "optax", "numpy"],
    extras_require={
        # the PPO variant family, vision policy and relation encoders
        "flax": ["flax"],
        # YAML config overlays
        "yaml": ["pyyaml"],
    },
)
