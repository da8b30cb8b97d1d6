"""Packaging for gym_fishing_tpu (pure Python on JAX; reference parity:
gym_fishing's setup.py, reconstructed — SURVEY.md §2.1)."""

from setuptools import find_packages, setup

setup(
    name="gym_fishing_tpu",
    version="0.1.0",
    description=(
        "Vectorized fisheries-management RL environments and learners "
        "(gym_fishing rebuilt on JAX/XLA)"
    ),
    author="gym_fishing_tpu developers",
    license="MIT",
    packages=find_packages(exclude=("tests",)),
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "optax",
        "pandas",        # analysis: simulate/plot helpers
        "matplotlib",
    ],
    extras_require={
        "flax": ["flax"],               # DQN, SAC, TD3, ES, recurrent PPO
        "gym": ["gymnasium"],
        "ckpt": ["orbax-checkpoint"],   # optional backend; npz is built in
        "test": ["pytest", "pytest-xdist", "flax", "gymnasium",
                 "orbax-checkpoint"],
    },
)
