"""Test harness config: CPU with an 8-device virtual mesh by default.

Multi-node testing strategy per SURVEY.md §4: simulate meshes on CPU with
`xla_force_host_platform_device_count=8` so shard_map / halo-exchange logic is
unit-tested without a GPU, asserting 1-device vs N-device consistency.
Must run before jax is imported anywhere.

Tests marked `gpu` need the card; on a GPU machine run them with
`JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`. Elsewhere they skip.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU (tests marked `gpu`)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev


@pytest.fixture(scope="session")
def oboe():
    """A deterministic synthetic stand-in for the reference's oboe asset
    (44.1 kHz, 2 s: harmonic stack + vibrato + noise floor)."""
    sr = 44100
    t = np.arange(sr * 2, dtype=np.float64) / sr
    f0 = 440.0 * (1.0 + 0.003 * np.sin(2 * np.pi * 5.0 * t))
    x = sum(
        a * np.sin(2 * np.pi * (k + 1) * f0 * t)
        for k, a in enumerate([0.5, 0.35, 0.2, 0.1, 0.05])
    )
    rng = np.random.default_rng(1234)
    x += 1e-4 * rng.standard_normal(len(t))
    x *= 0.5 / np.max(np.abs(x))
    return x.astype(np.float32), sr
