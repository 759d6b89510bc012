"""``config.upload``: a frame's globals cross to a device in one packed
copy, and the proof checks read the host's copy of what crossed.

The packed layout is read back leaf by leaf from its host buffer; an
upload to the ``meta`` device (which holds no data, so any read of it
from the host raises) makes one copy and hands back leaves of
``tree_to``'s dtypes, shapes and alias structure; ``trace.read_back``
serves an unchanged leaf from its mirror and reads the device once the
block was written; no mirror outlives its tensor; ``stack_views``
stacks the mirrors; and both proof checks refuse a stale plan through
mirrored leaves, with their words unchanged.
"""
import dataclasses
import gc

import numpy as np
import pytest
import torch

from soc_real_time_renderer_tpu_torch import config as pconfig
from soc_real_time_renderer_tpu_torch.camera import Camera3D, \
    camera_matrices
from soc_real_time_renderer_tpu_torch.config import (
    MAX_POINT_LIGHTS, MAX_SPOT_LIGHTS, LightArrays, RenderConfig,
    ShaderGlobals, SunInfo)
from soc_real_time_renderer_tpu_torch.graph import frame as fm
from soc_real_time_renderer_tpu_torch.graph import replay
from soc_real_time_renderer_tpu_torch.scene.components import \
    TransformComponent
from soc_real_time_renderer_tpu_torch.utils import trace

import torch_scene_kit as kit

META = torch.device("meta")


@pytest.fixture(autouse=True)
def _fresh():
    trace.reset()
    yield
    trace.reset()


def _host_frame(seed=0, entities=3):
    """(ShaderGlobals with host leaves, model mats, normal mats) of one
    frame: a jittered camera, a moved sun, live light slots, every
    scalar drawn from the seed; camera_prev is the camera's object."""
    rng = np.random.default_rng(seed)
    cam = Camera3D()
    cam.resize(96, 64)
    cam.view_mat = rng.standard_normal((4, 4)).astype(np.float32)
    cm = camera_matrices(cam, rng.standard_normal(3), 5, 96, 64)
    f3 = lambda n: rng.standard_normal((n, 3)).astype(np.float32)  # noqa
    f1 = lambda n: rng.standard_normal(n).astype(np.float32)  # noqa
    lights = LightArrays(
        point_position=f3(MAX_POINT_LIGHTS), point_color=f3(MAX_POINT_LIGHTS),
        point_intensity=f1(MAX_POINT_LIGHTS), point_count=np.int32(7),
        spot_position=f3(MAX_SPOT_LIGHTS), spot_direction=f3(MAX_SPOT_LIGHTS),
        spot_color=f3(MAX_SPOT_LIGHTS), spot_intensity=f1(MAX_SPOT_LIGHTS),
        spot_cut_off=f1(MAX_SPOT_LIGHTS),
        spot_outer_cut_off=f1(MAX_SPOT_LIGHTS), spot_count=np.int32(3))
    g = ShaderGlobals.create(
        camera=cm, camera_prev=cm, lights=lights,
        sun=SunInfo.create(position=tuple(rng.standard_normal(3))),
        elapsed_time=np.float32(rng.uniform()), delta_time=np.float32(0.02),
        frame_counter=np.int32(rng.integers(1 << 30)),
        ambient=f1(3), saturation=np.float32(rng.uniform()), device=None)
    mm = rng.standard_normal((entities, 4, 4)).astype(np.float32)
    return g, mm, mm[:, ::-1].copy()


def _same_leaves(got, want):
    """Every leaf of `got` equals `want`'s: dtype, shape, values."""
    a, b = replay._leaves(got), replay._leaves(want)
    assert len(a) == len(b) == 62 + 8
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def _aliases(tree):
    first = {}
    return [(tuple(t.shape), t.dtype, first.setdefault(id(t), i))
            for i, t in enumerate(replay._leaves(tree))]


def test_packed_layout_reads_back_every_leaf():
    """A full ShaderGlobals (int32 counts, 0-d scalars, (128, 3) light
    arrays, 4x4 matrices) and the two matrix stacks, packed into one host
    buffer and read back through their views: bit for bit tree_to's
    leaves, each view contiguous and PACK_ALIGN-aligned."""
    host = _host_frame()
    buf, tree, nbytes = pconfig.pack(host)
    views = pconfig.unpack(tree, torch.from_numpy(buf))
    want = tuple(pconfig.tree_to(x, "cpu") for x in host)
    _same_leaves(views, want)
    leaves = replay._leaves(views)
    assert {torch.int32, torch.float32} == {t.dtype for t in leaves}
    assert any(t.dim() == 0 and t.dtype == torch.int32 for t in leaves)
    assert sum(t.dim() == 0 for t in leaves) > 20
    base = torch.from_numpy(buf).data_ptr()
    for t in leaves:
        assert t.is_contiguous()
        assert (t.data_ptr() - base) % pconfig.PACK_ALIGN == 0
    # camera_prev is the camera: one object, packed once
    assert views[0].camera_prev is views[0].camera
    assert nbytes == sum(t.numel() * t.element_size() for t in leaves) \
        - sum(t.numel() * t.element_size()
              for t in replay._leaves(views[0].camera))
    assert buf.size % pconfig.PACK_ALIGN == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_upload_to_a_device_is_one_copy_of_tree_tos_leaves(seed):
    """On a device (meta) the frame crosses in one copy of the leaves'
    bytes; every leaf has tree_to's dtype and shape, the block's version
    counter, and tree_to's alias structure (camera_prev the camera's
    tensors, the sun's y-clip trick a tensor of its own each time)."""
    host = _host_frame(seed)
    g, mm, nm = pconfig.upload(host, META)
    up = trace.snapshot()["counters"]
    trace.reset()
    # the leaf-by-leaf path: the camera first, then the tree around it
    cam = pconfig.tree_to(host[0].camera, META)
    want = (pconfig.tree_to(dataclasses.replace(host[0], camera=cam,
                                                camera_prev=cam), META),
            *(pconfig.tree_to(m, META) for m in host[1:]))
    legacy = trace.snapshot()["counters"]
    assert up["h2d_copies"] == 1
    assert up["h2d_bytes"] == legacy["h2d_bytes"]
    assert legacy["h2d_copies"] == 62
    assert _aliases((g, mm, nm)) == _aliases(want)
    leaves = replay._leaves((g, mm, nm))
    assert {t.device for t in leaves} == {META}
    assert len({t._version for t in leaves}) == 1
    assert all(t.is_contiguous() for t in leaves)


def test_upload_to_the_cpu_is_tree_to():
    """On the CPU target upload is tree_to: no copy is counted, no mirror
    is made, the leaves equal tree_to's."""
    host = _host_frame(2)
    n0 = len(trace._mirrors)
    got = pconfig.upload(host, "cpu")
    _same_leaves(got, tuple(pconfig.tree_to(x, "cpu") for x in host))
    assert len(trace._mirrors) == n0
    assert trace.snapshot()["counters"] == {}
    assert trace.mirrored(got[0].sun.projection_view) is None


def test_leaves_already_on_the_device_stay():
    """A leaf already on the device (a set_sun sun, the last frame's
    camera) is handed back as itself and adds no bytes."""
    sun = SunInfo.create(position=(0.0, 8.0, 0.0), device=META)
    prev = pconfig.upload(_host_frame(3)[0].camera, META)
    trace.reset()
    g = pconfig.upload(dataclasses.replace(
        _host_frame(4)[0], sun=sun, camera_prev=prev,
        terrain_y_clip_trick=sun.terrain_y_clip_trick), META)
    assert g.sun is not sun and g.sun.projection_view is sun.projection_view
    assert g.terrain_y_clip_trick is sun.terrain_y_clip_trick
    assert g.camera_prev.view is prev.view
    assert trace.snapshot()["counters"]["h2d_copies"] == 1


def test_read_back_serves_the_mirror_until_the_block_is_written():
    """read_back of an unchanged uploaded leaf returns the values that
    crossed without touching the device (meta holds no data) and counts
    d2h_mirrored.<site>; an in-place write to another leaf of the same
    block invalidates it: the read goes to the device (counted in
    d2h_reads.<site>), which on meta has nothing to give."""
    host = _host_frame(5)
    g, mm, nm = pconfig.upload(host, META)
    pv = trace.read_back(g.sun.projection_view, "site")
    got = trace.read_back(mm, "site")
    assert np.array_equal(pv, host[0].sun.projection_view.numpy())
    assert np.array_equal(got, host[1])
    got[:] = 0           # a copy: the mirror stays as it crossed
    assert np.array_equal(trace.read_back(mm, "site"), host[1])
    assert trace.snapshot()["counters"] == {
        "h2d_copies": 1, "h2d_bytes": trace.counters["h2d_bytes"],
        "d2h_mirrored.site": 3}
    g.frame_counter.add_(1)
    with pytest.raises(NotImplementedError):
        trace.read_back(mm, "site")
    c = trace.snapshot()["counters"]
    assert c["d2h_reads.site"] == 1 and c["d2h_mirrored.site"] == 3


def test_no_mirror_outlives_its_tensor():
    """A run of uploads leaves the registry no larger than the live
    leaves: each entry goes with its tensor, and a tensor that reuses a
    freed one's id has no mirror."""
    n0 = len(trace._mirrors)
    for k in range(20):
        g, mm, nm = pconfig.upload(_host_frame(k), META)
        assert len(trace._mirrors) <= n0 + 2 * 62
    del g, mm, nm
    gc.collect()
    assert len(trace._mirrors) == n0
    fresh = [torch.empty(4, 4, device=META) for _ in range(200)]
    assert all(trace.mirrored(t) is None for t in fresh)


def test_stack_views_carries_the_mirrors():
    """stack_views of uploaded views: a stacked leaf whose every view has
    a mirror has the stack of them (views4's g.sun); one view without a
    mirror leaves the stacked leaf without."""
    hosts = [_host_frame(10 + b) for b in range(4)]
    gs = [pconfig.upload(h[0], META) for h in hosts]
    gb = pconfig.stack_views(gs)
    pv = trace.read_back(gb.sun.projection_view, "s")
    assert pv.shape == (4, 4, 4)
    assert np.array_equal(pv, np.stack(
        [h[0].sun.projection_view.numpy() for h in hosts]))
    assert np.array_equal(trace.read_back(gb.frame_counter, "s"),
                          [h[0].frame_counter for h in hosts])
    assert trace.counters["d2h_mirrored.s"] == 2
    gs[2] = pconfig.tree_to(hosts[2][0], META)
    gb = pconfig.stack_views(gs)
    assert trace.mirrored(gb.sun.projection_view) is None
    assert trace.mirrored(gb.camera.view) is None


def _on_meta(built):
    """`built` with its frames' globals made on the meta device."""
    built.device = META
    return built


def test_sun_proof_refuses_a_moved_sun_through_the_mirror():
    """check_sun_proof on globals uploaded to meta: the default sun
    passes and a set_sun sun (made by the same upload) is refused with
    the unchanged words, each read from the mirror."""
    built = _on_meta(kit.build_port(
        "full_nohelmet", RenderConfig(width=64, height=32,
                                      shadow_resolution=512), "cpu",
        noise=False))
    assert built.plan.shadow_statically_empty
    g, _, _ = built.frame_globals(0, peek=True)
    fm.check_sun_proof(built.plan, g)
    built.set_sun(position=(0.0, 8.0, 0.0))
    g, _, _ = built.frame_globals(1, peek=True)
    with pytest.raises(ValueError, match="proved for a different sun "
                       "projection_view than this frame's g.sun"):
        fm.check_sun_proof(built.plan, g)
    c = trace.snapshot()["counters"]
    assert c["d2h_mirrored.check_sun_proof"] == 2
    assert "d2h_reads.check_sun_proof" not in c


def test_shadow_crop_refuses_moved_model_matrices_through_the_mirror():
    """check_shadow_crop on model matrices uploaded to meta: the proved
    transforms pass, the atrium moved by half a unit is refused with the
    unchanged words, each read from the mirror."""
    built = _on_meta(kit.build_port(
        "atrium_lifted", RenderConfig(width=64, height=32,
                                      shadow_resolution=1024), "cpu",
        noise=False))
    assert built.plan.shadow_crop is not None
    _, mm, _ = built.frame_globals(0, peek=True)
    fm.check_shadow_crop(built.plan, mm)
    e = built.scene.mesh_entities()[0]
    e.get_component(TransformComponent).set_position([0.5, 32.0, 0.0])
    _, mm, _ = built.frame_globals(1, peek=True)
    with pytest.raises(ValueError, match="FramePlan.shadow_crop was proved "
                       "for different model matrices than this frame's"):
        fm.check_shadow_crop(built.plan, mm)
    c = trace.snapshot()["counters"]
    assert c["d2h_mirrored.check_shadow_crop"] == 2
    assert "d2h_reads.check_shadow_crop" not in c
