"""Process set-up shared by the entry points (CLI, chip_smoke.py, bench.py,
tools/): JAX's persistent compilation cache and the accelerator check."""
from __future__ import annotations

import os
import subprocess

# The cache key includes the cache path, so it lives at one fixed place in
# the checkout (listed in .gitignore), never under a per-run name.
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and
    nothing is changed; otherwise the cache goes to ``CACHE_DIR``.  Call
    before the first compilation: JAX opens the cache once per process."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR


def require_gpu(devices=None):
    """The first JAX device, which must be a GPU; raises RuntimeError
    naming what JAX found otherwise (measurements never fall back to the
    CPU)."""
    if devices is None:
        import jax
        devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX found {len(devices)} {dev.platform} device(s) "
            f"({dev.device_kind}); this run needs an NVIDIA GPU")
    return dev


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, one per line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
