"""Test configuration: an 8-device virtual CPU backend.

Multi-device sharding is tested without accelerators exactly as SURVEY.md
section 4 prescribes: the CPU backend with
--xla_force_host_platform_device_count=8 and the same mesh code that runs
on the cards.  Tests run on the CPU unless JAX_PLATFORMS chooses another
platform; tests that need a GPU carry the `gpu` marker and skip elsewhere
(the `gpu_device` fixture).  Must be set before JAX initializes.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax

# Test runs write no persistent compilation cache entries.
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX has none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run on the card: "
                    "python chip_smoke.py runs these tests)")
    return jax.devices()[0]


@pytest.fixture
def kernel_interpret(monkeypatch):
    """Route encodes through the GPU kernel under the Pallas interpreter
    (the path a GPU takes, runnable on the CPU)."""
    from huffman_tpu import backend
    monkeypatch.setattr(backend, "encode_path", lambda: backend.INTERPRET)
