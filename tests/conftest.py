"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The tests run on the CPU — fast, deterministic, and with 8 virtual devices
for the sharding logic. The GPU path is driven by `python chip_smoke.py`.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def counts_df():
    from ppcseq.data.datasets import load_counts

    return load_counts()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)
