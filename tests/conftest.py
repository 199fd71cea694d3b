"""Test configuration: JAX on a virtual 8-device CPU mesh.

The plain versions of every device op run on the CPU backend, the Triton
kernels in Pallas interpret mode, and multi-device sharding on the
virtual devices. Card-only tests carry the `gpu` marker and take the
`gpu_device` fixture: they skip here and run on an NVIDIA GPU with
SICELORE_TEST_GPU=1 (chip_smoke.py runs them as a phase), where the
platform is left to JAX and a missing GPU fails instead of skipping.
"""
import os

import pytest

ON_GPU = bool(os.environ.get("SICELORE_TEST_GPU"))
if not ON_GPU:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    # entry points turn the persistent compile cache on; tests write none
    jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run every Pallas kernel traced inside the test in interpret mode
    (the CPU has no Triton backend). Jit caches are cleared on both sides
    so no kernel trace crosses the fixture's boundary."""
    import functools

    from jax.experimental import pallas as pl

    jax.clear_caches()
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    yield
    jax.clear_caches()


@pytest.fixture
def gpu_device():
    """The GPU a card-only test runs on; decided here, at run time."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        if ON_GPU:
            pytest.fail(f"SICELORE_TEST_GPU=1 but JAX found {dev.platform}")
        pytest.skip("needs an NVIDIA GPU (SICELORE_TEST_GPU=1)")
    return dev
