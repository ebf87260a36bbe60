"""Test config: run everything on a virtual 8-device CPU mesh so sharding
tests work without accelerator hardware (SURVEY.md §4 'multi-node without a
cluster' analog — the reference runs gr-zeromq QA over localhost; we run
shard_map QA over a host-device mesh).

Tests that need a GPU carry the `gpu` marker and take the `gpu` fixture,
which skips them unless JAX's backend is a GPU. They run on a card with
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`; any other value of
JAX_PLATFORMS (or none) keeps the whole suite on the CPU.
"""
import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
).strip()

import jax

if os.environ.get("JAX_PLATFORMS", "cpu") in ("", "cpu"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skipped unless JAX's backend is one")


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU (jax backend is {jax.default_backend()!r})")
    return jax.devices()[0]


@pytest.fixture
def rng():
    return np.random.default_rng(42)
