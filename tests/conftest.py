"""Test configuration: an 8-device virtual CPU mesh by default.

Tests run on the CPU (deterministic, no accelerator needed; kernels run in
the Pallas interpreter); multi-device sharding tests use the 8 virtual
devices. Tests marked `gpu` need a card: run them with JAX_PLATFORMS=cuda
(`pytest -m gpu`); the `gpu_device` fixture skips them elsewhere.
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import pytest  # noqa: E402

# Persistent XLA compile cache: the suite is compile-bound, so repeat runs
# are much faster. Override dir via JAX_COMPILATION_CACHE_DIR; disable
# with PFV_TEST_CC=0.
if os.environ.get("PFV_TEST_CC", "1") != "0":
    _cc = os.environ.get(
        "JAX_COMPILATION_CACHE_DIR",
        os.path.join(os.path.dirname(__file__), ".xla_cache"),
    )
    os.makedirs(_cc, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", _cc)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

sys.path.insert(0, os.path.dirname(__file__))  # for `oracle` imports


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform})")
    return dev


# Modules dominated by whole-video encodes, subprocesses, or interpret-mode
# kernels — marked slow so `pytest -m "not slow"` gives a fast unit-level
# signal (the full suite takes >10 min on a 1-core host).
_SLOW_MODULES = {
    "test_cli",
    "test_dataloader",
    "test_encoding",
    "test_end_to_end",
    "test_gop_concurrent",
    "test_motion_content",
    "test_parallel",
    "test_robustness",
    "test_step_kernel",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.fspath.purebasename in _SLOW_MODULES:
            item.add_marker(pytest.mark.slow)
