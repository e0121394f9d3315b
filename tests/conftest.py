"""Test configuration: force CPU with 8 virtual devices.

Tests run on the CPU; ``--xla_force_host_platform_device_count=8`` gives
the sharding tests a virtual 8-device mesh.  The platform is pinned with
``jax.config.update`` after import (before any backend touch), so a GPU
on the host is never opened by the test process itself.

Tests that need an NVIDIA GPU are marked ``gpu``.  They drive the card
from a child process and skip where none is found; run them on a GPU
host with ``pytest -m gpu``.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running training test")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips where there is none "
                   "(run pytest -m gpu on a GPU host)")


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (full e2e trainings; ~10 extra minutes)",
    )


def pytest_collection_modifyitems(config, items):
    """Default suite stays fast: ``slow`` tests are skipped unless
    --runslow (or an explicit -m) selects them."""
    explicit_m = bool(config.getoption("-m"))
    skip_slow = pytest.mark.skip(reason="slow e2e test; pass --runslow")
    for item in items:
        if ("slow" in item.keywords and not explicit_m
                and not config.getoption("--runslow")):
            item.add_marker(skip_slow)


def _nvidia_gpu_found() -> bool:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return False
    try:
        out = subprocess.run([smi, "-L"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return False
    return out.returncode == 0 and "GPU" in out.stdout


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip a ``gpu`` test unless an NVIDIA GPU is found.  Decided here, at
    run time, never while modules are imported, so every xdist worker
    collects the same tests."""
    if (request.node.get_closest_marker("gpu") is not None
            and not _nvidia_gpu_found()):
        pytest.skip("needs an NVIDIA GPU (nvidia-smi lists none); run "
                    "pytest -m gpu on a GPU host")


@pytest.fixture(scope="session", autouse=True)
def _assert_cpu():
    assert jax.devices()[0].platform == "cpu", (
        "tests must run on CPU; got " + str(jax.devices())
    )
