"""Test configuration: run on CPU with 8 virtual devices and fp64.

The parity/correctness gates run in float64 on a simulated 8-device CPU mesh
(no multi-device machine needed for sharding tests), mirroring the plan in
SURVEY.md §4. The platform is pinned here, before any backend starts, so a
test run behaves the same with or without ``JAX_PLATFORMS=cpu`` in the
environment.

Tests that need an NVIDIA GPU carry the ``gpu`` marker and run only when
asked for with ``-m gpu`` (``python -m pytest tests/ -m gpu``): they drive
the whole smoke run on the card, far longer than the rest of the suite.
Their ``gpu_card`` fixture then skips them on a machine without a card.
They drive the card from a child process, so this process stays on the
CPU.
"""

import os
import shutil
import subprocess

# Must be set before the XLA CPU client starts.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def require_or_skip(modname: str):
    """Import an optional dependency; skip the test when it is absent.

    In CI the test job *declares* every optional dependency installed
    (``.github/workflows/ci.yml``) and sets ``CARTPOLE_REQUIRE_OPTIONAL=1``,
    which turns a missing module into a hard failure instead of a silent
    skip — the skip-count gate the round-2 review asked for: optional-dep
    tests cannot quietly vanish from the CI signal.
    """
    if os.environ.get("CARTPOLE_REQUIRE_OPTIONAL"):
        import importlib

        return importlib.import_module(modname)
    return pytest.importorskip(modname)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running test, opt in with CARTPOLE_SLOW_TESTS=1",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; runs only under -m gpu (takes the "
        "gpu_card fixture; skips without a card)",
    )


@pytest.fixture
def gpu_card():
    """The ``nvidia-smi -L`` line of the first GPU; skips the test when
    this machine has none. Decided when the test runs, never at import."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        pytest.skip("no NVIDIA GPU on this machine (nvidia-smi not found)")
    out = subprocess.run([smi, "-L"], capture_output=True, text=True,
                         timeout=60)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("GPU")]
    if out.returncode != 0 or not lines:
        pytest.skip("no NVIDIA GPU on this machine (nvidia-smi lists none)")
    return lines[0]


def gpu_tests_requested(markexpr: str) -> bool:
    """Whether the ``-m`` expression asks for the ``gpu`` tests."""
    return "gpu" in markexpr and "not gpu" not in markexpr


def pytest_collection_modifyitems(config, items):
    slow = not os.environ.get("CARTPOLE_SLOW_TESTS")
    gpu = not gpu_tests_requested(config.option.markexpr or "")
    skip_slow = pytest.mark.skip(
        reason="slow; set CARTPOLE_SLOW_TESTS=1 to run")
    skip_gpu = pytest.mark.skip(reason="gpu; run with -m gpu on a GPU machine")
    for item in items:
        if slow and "slow" in item.keywords:
            item.add_marker(skip_slow)
        if gpu and "gpu" in item.keywords:
            item.add_marker(skip_gpu)
