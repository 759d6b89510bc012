"""The G-buffer resolve's dispatch on the CPU (ops/gbuffer.resolve_gbuffer).

On a card the resolve is one hand kernel, K9 (kernels/csrc/gbuffer.cu),
held to the plain version bit for bit in tests/test_torch_cuda.py and
chip_smoke.py; it cannot compile here.  These tests hold what the CPU
can see: CPU tensors take the plain version and launch nothing, the
kernel path is refused on the CPU, K9 shares K5's tap code (one header,
no copy) and its filter modes with the wrapper, and tools/bench's
kernel path names K9 in every filter mode.
"""
import os
import re
from types import SimpleNamespace

import pytest
import torch

import torch_scene_kit as kit
from soc_real_time_renderer_tpu_torch.config import RenderConfig
from soc_real_time_renderer_tpu_torch.kernels import build as kb
from soc_real_time_renderer_tpu_torch.models.texture import \
    PackedMaterialAtlas, expand_atlas_bilinear
from soc_real_time_renderer_tpu_torch.ops import gbuffer, texsample
from soc_real_time_renderer_tpu_torch.tools import bench

TARGETS = ("albedo", "emissive", "normal", "metallic_roughness",
           "velocity", "depth")
CSRC = os.path.join(os.path.dirname(kb.__file__), "csrc")


def _atlas(M=3, size=64, seed=0):
    """A random M-material packed atlas table (N, 12) int32 and its size
    keywords."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n_levels = int(np.log2(size)) + 1
    stride = sum((size >> k) ** 2 for k in range(n_levels))
    atlas = PackedMaterialAtlas(
        packed=rng.integers(0, 256, (16, M * stride), dtype=np.uint8),
        size=size, num_materials=M, layer_stride=stride, n_levels=n_levels)
    return (torch.from_numpy(expand_atlas_bilinear(atlas)),
            dict(atlas_size=size, layer_stride=stride, n_levels=n_levels))


def _read(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "trilinear", "none"])
def test_cpu_resolve_is_the_plain_version_and_launches_nothing(mode):
    """CPU tensors (impl None) take the plain version: every target equal
    to impl="plain"'s, bit for bit, on hand-built records (D == 0, pc_w
    == 0, a zero tangent, the terrain branch, an all-miss block), and
    no kernel counted; the miss block is the sky clear, every target
    finite."""
    vis, rec, vp = kit.hand_gbuffer_inputs("cpu")
    table, kw = _atlas()
    before = dict(kb.launches)
    got = gbuffer.resolve_gbuffer(vis, rec, table, vp, filter_mode=mode,
                                  **kw)
    want = gbuffer.resolve_gbuffer(vis, rec, table, vp, filter_mode=mode,
                                   impl="plain", **kw)
    assert kb.launches == before and not kb.variant_launches
    for name in TARGETS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape and torch.equal(a, b), name
        assert torch.isfinite(a).all(), name
    assert torch.equal(got.albedo[:, 8:16, 32:64],
                       torch.tensor([0.2, 0.4, 1.0])[:, None, None]
                       .expand(3, 8, 32))
    assert not got.velocity[:, 8:16, 32:64].any()


def test_cpu_resolve_refuses_the_kernel_and_unknown_modes():
    """impl="cuda" on CPU tensors raises before anything runs (the
    kernels never run on the CPU); an unknown filter mode raises on
    both paths."""
    vis, rec, vp = kit.hand_gbuffer_inputs("cpu")
    table, kw = _atlas()
    before = dict(kb.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gbuffer.resolve_gbuffer(vis, rec, table, vp, impl="cuda", **kw)
    for impl in (None, "plain"):
        with pytest.raises(ValueError, match="filter_mode"):
            gbuffer.resolve_gbuffer(vis, rec, table, vp, impl=impl,
                                    filter_mode="cubic", **kw)
    assert kb.launches == before


def test_the_kernel_shares_k5s_tap_code_and_modes():
    """K9 taps through texsample.cuh, the header K5 includes: the level
    fetch and the tap are defined there and in neither kernel's source;
    K9's modes are K5's ids plus "none", the kernel's kModeNone."""
    header, k5, k9 = (_read(n) for n in ("texsample.cuh", "texsample.cu",
                                         "gbuffer.cu"))
    for src in (k5, k9):
        assert '#include "texsample.cuh"' in src
    for fn in ("level_fetch", "tap_value"):
        define = re.compile(r"__device__ __forceinline__ void " + fn + r"\(")
        assert define.search(header), fn
        assert not define.search(k5) and not define.search(k9), fn
    assert "tap_value<0, 1>(" in k9 and "tap_value<kSkip, kLanes>(" in k5
    none = int(re.search(r"constexpr int kModeNone = (\d+);", k9).group(1))
    assert gbuffer.FILTER_MODES == {**texsample.FILTER_MODES, "none": none}
    assert "__global__ void gbuffer_resolve_kernel(" in k9


@pytest.mark.parametrize("texture_filter",
                         ["nearest", "bilinear", "trilinear", "none"])
def test_kernel_path_names_the_gbuffer_resolve(texture_filter):
    """tools/bench.kernel_path names K9 (gbuffer_resolve) after K1 in
    every filter mode, the probe "none" too, and never K5 (texsample),
    whose tap K9 does."""
    plan = SimpleNamespace(config=RenderConfig(max_point_lights=0,
                                               max_spot_lights=0),
                           texture_filter=texture_filter,
                           shadow_statically_empty=True)
    path = bench.kernel_path(plan, SimpleNamespace(cloud_noise=None))
    assert path[:2] == ["resolve", "gbuffer_resolve"]
    assert "texsample" not in path
