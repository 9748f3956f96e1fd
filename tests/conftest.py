"""Test configuration: CPU backend with 8 virtual devices, x64.

The platform is forced through jax.config before any jax use, so the
suite runs on the CPU even on a machine with a GPU.  The persistent
compilation cache follows the package's own rule (nupgcm/__init__.py).
Tests that need a GPU carry the ``gpu`` marker and skip elsewhere.
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips where JAX finds none")
    config.addinivalue_line("markers", "slow: long-running")
