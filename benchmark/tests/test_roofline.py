"""The frozen bound arithmetic reproduces the kernel table's bound column
(PERF.md, the port's kernel table) at the home shapes."""
import pytest
import torch

from benchmark import roofline


def test_taa_bound_at_1080p():
    # K3 on terrain 1920x1088: 0.0237 ms (bytes)
    assert roofline.bound_ms(*roofline.taa_job(1088, 1920)) == \
        pytest.approx(0.0237, abs=5e-5)


def test_tap_bound_at_the_full_frame():
    # K5 on full's frame 1: 2,088,960 pixels, 43,182 distinct atlas rows
    # (bilinear): 0.0380 ms (bytes)
    assert roofline.bound_ms(*roofline.tap_job(2088960, 43182)) == \
        pytest.approx(0.0380, abs=5e-5)


def test_resolve_bound_at_1080p():
    # K1 on terrain: 0.0066 ms (bytes); the bin grid's depth and ids
    # alone are 16.7 MB of it, the pair stream the rest
    nbytes, ops = roofline.resolve_job(84000, 1_000_000, 1920, 1088)
    assert roofline.bound_ms(nbytes, ops) == pytest.approx(0.0066,
                                                          abs=5e-5)
    assert nbytes == (30 * 34 + 1) * 4 + 64 * 84000 + 1920 * 1088 * 8


def test_ssao_bound_is_operations():
    nbytes, ops = roofline.ssao_job(544, 960, 1088, 1920)
    assert ops / roofline.F32_OPS > nbytes / roofline.HBM_BPS
    assert roofline.bound_ms(nbytes, ops) == pytest.approx(0.0162,
                                                          abs=5e-5)


def test_pair_count_counts_bins_of_each_valid_box():
    # boxes (x0, y0, x1, y1): one bin; 2 x 2 bins; invalid
    bbox = torch.tensor([[0., 60., 0.], [0., 20., 0.], [10., 70., 500.],
                         [10., 40., 500.]])
    valid = torch.tensor([True, True, False])
    assert roofline.pair_count(bbox, valid, 1920, 1088) == 1 + 4


def test_tap_rows_counts_distinct_rows():
    mid = torch.zeros(4, dtype=torch.int32)
    uv = torch.tensor([[0.1, 0.1, 0.6, 0.6], [0.1, 0.1, 0.1, 0.1]])
    lod = torch.zeros(4)
    assert roofline.tap_rows(mid, uv, lod, size=8, layer_stride=100,
                             n_levels=1) == 2
