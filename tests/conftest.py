"""Test config: CPU backend with 8 virtual devices + float64 enabled.

- 8 virtual CPU devices let the mesh/sharding tests run without several
  accelerators (SURVEY.md §7.5 — the fake-backend trick).
- x64 is enabled so the exactness harness can run the JAX engine in float64
  and compare against the NumPy oracle at near-bit level (SURVEY.md §7.4).

Must run before jax is imported anywhere.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# Select the CPU through the config too, in case a plugin registered another
# backend before this file ran.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running (multi-process) test")
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; decides inside the test and skips on CPU runs",
    )
