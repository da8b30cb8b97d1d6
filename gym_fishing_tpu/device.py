"""Device choice, device report and compile-cache placement.

The measurement and smoke entry points (``bench.py``, ``chip_smoke.py``,
``__graft_entry__.py``) ask for the accelerator here. ``require`` returns the
devices of the platform asked for or raises: it never swaps in the CPU or an
interpreter, so a number measured through it always names the device that
produced it. Test runs select the CPU explicitly (``tests/conftest.py``).
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

import jax

REPO_ROOT = Path(__file__).resolve().parent.parent
# Fixed, inside the checkout and listed in .gitignore: the cache key includes
# the path, so a directory that moves between runs never hits.
DEFAULT_CACHE_DIR = REPO_ROOT / ".jax_cache"
_CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


class DeviceUnavailable(RuntimeError):
    """The platform asked for is absent or has too few devices."""


def require(platform: str = "gpu", count: int = 1) -> List[jax.Device]:
    """The first ``count`` devices of ``platform``, or DeviceUnavailable."""
    try:
        devices = jax.devices(platform)
    except RuntimeError as e:
        raise DeviceUnavailable(f"no {platform!r} backend: {e}") from e
    if len(devices) < count:
        raise DeviceUnavailable(
            f"need {count} {platform!r} device(s), found {len(devices)}"
        )
    return list(devices[:count])


def describe(devices: Sequence[jax.Device]) -> Dict[str, object]:
    """``{"platform", "kind", "count"}`` of a device list, as JAX reports it."""
    if not devices:
        raise DeviceUnavailable("no devices to describe")
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, one line per card.

    Runs in a child process that never imports JAX. Raises when nvidia-smi is
    missing or fails: a card whose limit cannot be read is not reported.
    """
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` if set, else the fixed in-checkout path."""
    return os.environ.get(_CACHE_ENV) or str(DEFAULT_CACHE_DIR)


def setup_compile_cache() -> str:
    """Point JAX's persistent compile cache at ``compile_cache_dir()``.

    Sets no other directory when ``$JAX_COMPILATION_CACHE_DIR`` is set; call
    before the first compilation. Returns the directory in use.
    """
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
