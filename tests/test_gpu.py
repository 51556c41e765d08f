"""Checks that need an NVIDIA GPU. They skip elsewhere; ``chip_smoke.py``
runs the same checks as its phases on the card."""

import importlib.util
import os

import jax
import pytest


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU (decided at run time)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this check "
                    "on the card (phase 0)")
    return jax.devices()[0]


@pytest.mark.gpu
def test_highest_matmul_precision_is_fp32(gpu):
    """matmul_precision="highest" must give FP32, not TF32: a 512x512 f32
    product within 1e-5 relative of float64."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.phase_precision(512) <= 1e-5
