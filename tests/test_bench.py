"""bench.py's peak table: known cards, precision tiers, unknown devices."""

import pytest

import bench

H100_SXM = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("precision,name,tflops", [
    ("highest", "fp32", 67.0),
    ("high", "tf32", 495.0),
    ("default", "tf32", 495.0),
])
def test_peak_of_h100_per_precision(precision, name, tflops):
    assert bench.peak_flops(H100_SXM, precision) == (name, tflops * 1e12)


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB",
                                  "NVIDIA H200"])
def test_unknown_device_is_an_error(kind):
    with pytest.raises(KeyError, match="no peak rates"):
        bench.peak_flops(kind, "highest")
