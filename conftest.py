"""Test env: unless JAX_PLATFORMS says otherwise, run on the CPU with 8
virtual devices, so the sharding/halo-exchange tests have a mesh.  This must
happen before any backend is initialised.

Tests marked ``gpu`` need an NVIDIA GPU; on the machine with the card run
them with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
