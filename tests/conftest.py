"""Test harness: force the CPU backend with 8 virtual devices so the
full suite — including multi-device shard_map tests — runs without a
GPU (SURVEY.md §4: "test multi-node without a real cluster").

``jax.config.update`` below wins as long as it runs before the first
``jax.devices()`` call.  On the CPU backend the detection products run
the plain form; the kernel tests ask for the Pallas interpreter
explicitly (``interpret=True``).

``DSABF_GPU_TESTS=1`` opts out of the CPU forcing so the ``gpu``-marked
tests (tests/test_gpu_hw.py) run on a machine with a card:

    DSABF_GPU_TESTS=1 python -m pytest -m gpu tests/
"""

import os

# Belt and braces for subprocesses spawned by tests.  XLA's CPU kernels
# run single-threaded: the suite runs in several worker processes at
# once, and multi-threaded kernels in each oversubscribe the cores and
# stall the timing-sensitive soak test (tests/test_soak.py).
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8"
                      " --xla_cpu_multi_thread_eigen=false")

_GPU_RUN = os.environ.get("DSABF_GPU_TESTS") == "1"

import jax

if not _GPU_RUN:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    # Full float64 for the device-side weight-phase math (on the card
    # the same code runs in f32, which the accuracy tests show is
    # sufficient; CPU tests get oracle precision).
    jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from dsabeamformer.config import TINY  # noqa: E402


@pytest.fixture(scope="session", autouse=True)
def _check_backend():
    if _GPU_RUN:
        return
    assert jax.default_backend() == "cpu", (
        "tests must run on the CPU backend; got " + jax.default_backend()
    )
    assert len(jax.devices()) == 8


@pytest.fixture(scope="session")
def tiny_cfg():
    return TINY


@pytest.fixture()
def rng():
    return np.random.default_rng(1234)
