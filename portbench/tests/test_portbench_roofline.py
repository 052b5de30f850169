"""The yardstick's arithmetic against hand counts."""

import json

import pytest

from portbench import roofline, spec

# hand count: ResNet-50 v1.5 at 224x224 (conv and fc multiply-adds of one
# image's forward)
RESNET50_MACS = 4_089_184_256


def _cfg(name):
    return spec.config(spec.load_benchmark(), name)


@pytest.mark.parametrize("name,macs,params", [
    ("resnet50_v1.5", RESNET50_MACS, 25_557_032)])
def test_macs_and_params_match_hand_counts(name, macs, params):
    cfg = _cfg(name)
    assert roofline.forward_macs(cfg) == macs
    assert roofline.train_flops_per_sample(cfg) == 6 * macs
    assert roofline.param_count(cfg) == params == cfg["params"]


def test_hand_count_in_gflop():
    assert 6 * RESNET50_MACS / 1e9 == pytest.approx(24.535, abs=1e-3)


def test_sgd_bound_is_twelve_bytes_a_parameter_at_hbm_rate():
    n = 25_557_032
    assert roofline.sgd_bound_s(n) == pytest.approx(12 * n / 3.35e12)
    # the byte bound, not the operations, sets it
    assert 2 * n / roofline.PEAK_FLOPS["float32"] < 12 * n / 3.35e12


def test_peaks_cover_every_configured_precision():
    bench = spec.load_benchmark()
    for c in bench["configs"]:
        cfg = spec.config(bench, c["name"])
        assert cfg["compute_dtype"] in roofline.PEAK_FLOPS
    assert roofline.PEAK_FLOPS["bfloat16"] == 989e12
    assert roofline.PEAK_FLOPS["float32"] == 67e12
    json.dumps(roofline.PEAK_FLOPS)
