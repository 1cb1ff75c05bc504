"""Tests run on the CPU with 8 virtual devices, so the multi-device
sharding paths are exercised without accelerators. The flags must be set
before JAX initializes its backends."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
