"""Test config: force the CPU backend with 8 virtual devices and enable x64.

Tests run on the CPU; the multi-device sharding tests use a virtual
8-device CPU mesh, and bit-exactness tests need float64. Tests that need a
GPU carry the ``gpu`` marker and skip here (tests/test_gpu.py decides in a
fixture); run them on the card with ``python -m pytest tests/test_gpu.py``.
"""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips with a reason where there is none")
