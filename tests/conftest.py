"""Test configuration: the CPU with 8 virtual devices, or a GPU on request.

Multi-device sharding is validated on a virtual CPU mesh
(`xla_force_host_platform_device_count`), replacing the reference's
real-cluster-only Slurm testing (SURVEY.md §4). With ``JAX_PLATFORMS=cuda``
the suite runs on the card instead, and the tests marked ``gpu`` run too:

    JAX_PLATFORMS=cuda python -m pytest tests/ -q -m gpu
"""

import os

# Anything but an explicit CUDA run is forced onto the CPU: both the env var
# and the live config (JAX may already be imported) are set before any
# backend starts.
ON_CUDA = os.environ.get("JAX_PLATFORMS") == "cuda"
if not ON_CUDA:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

from msa_tpu.utils import jaxenv  # noqa: E402,F401  (compile cache)

import jax  # noqa: E402

if not ON_CUDA:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

import pathlib  # noqa: E402

import pytest  # noqa: E402

DATA = pathlib.Path(__file__).resolve().parent.parent / "data"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU; skips elsewhere (see conftest)"
    )


@pytest.fixture(scope="session")
def data_dir() -> pathlib.Path:
    return DATA


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX runs on anything else."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU (run with JAX_PLATFORMS=cuda)")
    return jax.devices()[0]
