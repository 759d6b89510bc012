"""The CUDA kernels (K1 resolve, K2 SSAO taps, K3 TAA reprojection, K3f
the fused TAA resolve, K4 shadow depth resolve, K5 texture tap, K6 noise
sky LUT, K6p procedural sky LUT, K7 local lights, K8 the SSR march, K9
the G-buffer resolve)
against their plain PyTorch versions on the card, at small sizes (K7 at
the lit atrium's 1920x1088), and small frames of the terrain and of the
two multi-entity scenes through both paths.
Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is false
(this file imports no jax, so it also runs where only PyTorch is
installed):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import torch_scene_kit as kit
from soc_real_time_renderer_tpu_torch import scenes
from soc_real_time_renderer_tpu_torch.camera import Camera3D, \
    camera_matrices
from soc_real_time_renderer_tpu_torch.config import RenderConfig, \
    ShaderGlobals
from soc_real_time_renderer_tpu_torch.graph import frame as fm
from soc_real_time_renderer_tpu_torch.kernels import build as kb
from soc_real_time_renderer_tpu_torch.models import terrain
from soc_real_time_renderer_tpu_torch.models.texture import \
    PackedMaterialAtlas, expand_atlas_bilinear
from soc_real_time_renderer_tpu_torch.ops import clouds, raster2, sky, \
    ssao, ssr, taa, texsample
from soc_real_time_renderer_tpu_torch.scene.components import \
    MeshComponent, TransformComponent
from soc_real_time_renderer_tpu_torch.scene.scene import Scene
from soc_real_time_renderer_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda

# the kernels no frame of a scene with the cloud-noise texture, no light
# and SSR off launches: K6p (the procedural LUT), K3 alone (the frame's
# TAA is the fused resolve, taa_resolve, whose fetch is K3's), K5 alone
# (the frame's G-buffer resolve, K9, taps through K5's device code), K7
# (the local lights) and K8 (the SSR march)
OFF_FRAME = ("sky_lut_procedural", "taa_reproject", "texsample",
             "local_lights", "ssr_march")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda:0")


def _soup(n, seed, w, h, z=(-4.0, -2.0), spread=0.5, squash=(1, 1, 1)):
    """(3, 4, n) planar clip positions of n view-space triangles around
    centres with view z in `z` (z > 0 lies behind the camera), vertices
    within `spread`, scaled by `squash` (the oracle's slivers: y * 0.02)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform([-1, -1, z[0]], [1, 1, z[1]], (n, 1, 3))
    v = ((c + rng.uniform(-spread, spread, (n, 3, 3)))
         * np.asarray(squash, np.float32)).astype(np.float32)
    from soc_real_time_renderer_tpu_torch.utils import mathutil as mu
    p = mu.perspective(90.0, w / h, 0.1, 100.0)
    clip = v @ p[:, :3].T + p[:, 3]
    return torch.from_numpy(np.ascontiguousarray(
        clip.transpose(1, 2, 0).astype(np.float32)))


def _resolve_both(setup, grid):
    """K1 and resolve_plain on the setup's records: asserts one launch
    and bit-identical (depth, tri_id); returns (tri_id, starts)."""
    starts, recs, _, rgrid = raster2.gather_records(setup, grid)
    n0 = kb.launches["resolve"]
    dk, ik = raster2.resolve(starts, recs, rgrid)
    assert kb.launches["resolve"] == n0 + 1
    dp, ip = raster2.resolve(starts, recs, rgrid, impl="plain")
    torch.cuda.synchronize()
    assert torch.equal(ik, ip)
    assert torch.equal(dk, dp)
    return ik, starts


@pytest.mark.parametrize("w,h,bins", [(128, 64, (64, 32)), (96, 96, (32, 32)),
                                      (256, 128, (64, 64))])
def test_resolve_kernel_matches_plain(dev, w, h, bins):
    grid = raster2.BinGrid(width=w, height=h, bin_w=bins[0], bin_h=bins[1],
                           pair_cap=16384, med_cap=256)
    clip = _soup(300, w + h, w, h).to(dev)
    setup = raster2.triangle_setup_planar(clip, w, h, "none")
    starts, recs, _, rgrid = raster2.gather_records(setup, grid)
    n0 = kb.launches["resolve"]
    dk, ik = raster2.resolve(starts, recs, rgrid)
    assert kb.launches["resolve"] == n0 + 1
    dp, ip = raster2.resolve(starts, recs, rgrid, impl="plain")
    torch.cuda.synchronize()
    assert torch.equal(ik, ip)
    assert torch.equal(dk, dp)
    assert (ik >= 0).float().mean() > 0.1


@pytest.mark.parametrize("cull", ["front", "none"])
def test_resolve_kernel_behind_and_across_the_camera(dev, cull):
    """A soup from behind the camera to in front of it: triangles with
    no w > 0 (binned into bin 0, rejected whole by K1) and triangles
    crossing the near plane; bit-identical to resolve_plain."""
    w, h = 256, 128
    grid = raster2.BinGrid(width=w, height=h, bin_w=64, bin_h=32,
                           pair_cap=32768, med_cap=1024)
    clip = _soup(1500, 7, w, h, z=(-5.0, 3.0), spread=1.5).to(dev)
    setup = raster2.triangle_setup_planar(clip, w, h, cull)
    pos = setup.ws > 0
    assert int((~pos.any(0) & setup.valid).sum()) > 100
    assert int((pos.any(0) & ~pos.all(0) & setup.valid).sum()) > 10
    ik, _ = _resolve_both(setup, grid)
    assert (ik >= 0).float().mean() > 0.1


def test_resolve_kernel_one_heavy_bin(dev):
    """One 64x32 bin of >= 20,000 pairs (small triangles, and 5,000
    wholly behind the camera), so every block of the bin walks a long
    pair range."""
    rng = np.random.default_rng(9)
    n = 25_000
    xy = rng.uniform(-1, 1, (n, 1, 2)) + rng.uniform(-0.15, 0.15, (n, 3, 2))
    wv = rng.uniform(0.5, 2.0, (n, 1, 1)).repeat(3, axis=1)
    wv[:5000] *= -1.0
    z = rng.uniform(0.05, 0.95, (n, 3, 1))
    clip = np.concatenate([xy * wv, z * wv, wv], axis=2).astype(np.float32)
    clip = torch.from_numpy(np.ascontiguousarray(clip.transpose(1, 2, 0)))
    grid = raster2.BinGrid(width=64, height=32, bin_w=64, bin_h=32, group=1,
                           pair_cap=32768, med_cap=256)
    setup = raster2.triangle_setup_planar(clip.to(dev), 64, 32, "none")
    ik, starts = _resolve_both(setup, grid)
    assert grid.num_bins == 1 and int(starts[-1]) >= 20_000
    assert (ik >= 0).float().mean() > 0.9


def test_resolve_kernel_exact_ties_take_the_lower_id(dev):
    """800 triangles on one view plane (one depth quantum, so each bin's
    pairs sort by id) with triangles 0 and 1 repeated as ids 799 and
    400: the copies sit far apart in the bin's pair range from their
    originals, tie on z at every pixel, and never win."""
    rng = np.random.default_rng(10)
    n = 800
    c = rng.uniform([-1.5, -1.5], [1.5, 1.5], (n, 1, 2))
    xy = c + rng.uniform(-0.4, 0.4, (n, 3, 2))
    v = np.concatenate([xy, np.full((n, 3, 1), -2.0)], axis=2)
    v[n - 1], v[n // 2] = v[0], v[1]
    from soc_real_time_renderer_tpu_torch.utils import mathutil as mu
    w, h = 128, 64
    p = mu.perspective(90.0, w / h, 0.1, 100.0)
    clip = (v.astype(np.float32) @ p[:, :3].T + p[:, 3]).astype(np.float32)
    clip = torch.from_numpy(np.ascontiguousarray(clip.transpose(1, 2, 0)))
    grid = raster2.BinGrid(width=w, height=h, bin_w=64, bin_h=32,
                           pair_cap=8192, med_cap=1024)
    setup = raster2.triangle_setup_planar(clip.to(dev), w, h, "none")
    ik, _ = _resolve_both(setup, grid)
    assert bool((ik == 0).any()) and bool((ik == 1).any())
    assert not bool((ik == n - 1).any()) and not bool((ik == n // 2).any())


@pytest.mark.parametrize("bins", [(64, 32), (32, 32)])
def test_resolve_kernel_slivers(dev, bins):
    """The raster oracle's slivers (tests/test_torch_raster.py: y * 0.02)
    on a 256x256 target, where they cover pixels."""
    grid = raster2.BinGrid(width=256, height=256, bin_w=bins[0],
                           bin_h=bins[1], pair_cap=4096, med_cap=256)
    clip = _soup(60, 2, 256, 256, squash=(1.0, 0.02, 1.0)).to(dev)
    setup = raster2.triangle_setup_planar(clip, 256, 256, "none")
    ik, _ = _resolve_both(setup, grid)
    assert int((ik >= 0).sum()) > 100


def _ssao_inputs(dev, h, w, H, W, k, radius=0.3, seed=0, depth=None,
                 zero_w_rows=False):
    """Random K2 inputs: planes (12, h, w) with view z in front, a depth
    field (H, W), the camera's projection pair (their w rows zeroed for
    the `ow == 0` / `vw == 0` guards), k hemisphere vectors (the
    renderer's table up to 26, random ones past it)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    planes = torch.randn(12, h, w, generator=g)
    planes[2] = -planes[2].abs() - 2.0
    if depth is None:
        depth = torch.rand(H, W, generator=g) * 0.2 + 0.79
    cam = scenes.Camera3D()
    cam.resize(W, H)
    proj = torch.from_numpy(cam.proj_mat).clone()
    iproj = torch.linalg.inv(proj)
    if zero_w_rows:
        proj[3] = 0.0
        iproj[3] = 0.0
    if k <= len(ssao.KERNEL):
        kern = ssao.kernel_vectors(k, dev)
    else:
        kern = torch.rand(k, 3, generator=g) * 2.0 - 1.0
    return (planes.to(dev), depth.to(dev), proj.to(dev), iproj.to(dev),
            torch.tensor(radius, device=dev),
            torch.tensor(0.025, device=dev), kern.to(dev))


def test_ssao_kernel_matches_plain(dev):
    args = _ssao_inputs(dev, 48, 80, 96, 160, 26)
    k = ssao.ssao_taps(*args)
    p = ssao.ssao_taps(*args, impl="plain")
    torch.cuda.synchronize()
    assert torch.equal(k, p)
    assert 0.05 < float((p < 1.0).float().mean()), "some pixel is occluded"


SSAO_CASES = {
    # h, w, H, W, k, then _ssao_inputs' keywords
    "ragged_width": (45, 37, 90, 74, 26, {}),
    "odd_full_res": (45, 37, 91, 75, 26, {}),
    "one_pixel": (1, 1, 2, 2, 26, {}),
    "one_pixel_odd": (1, 1, 3, 3, 7, {}),
    "k1": (33, 70, 66, 140, 1, {}),
    "k7": (33, 70, 66, 140, 7, {}),
    "k64": (33, 70, 66, 140, 64, {}),
    "taps_leave_the_screen": (48, 80, 96, 160, 26, {"radius": 500.0}),
    "zero_w_guards": (48, 80, 96, 160, 26, {"zero_w_rows": True}),
    "all_sky": (48, 80, 96, 160, 26, {"depth": "ones"}),
}


@pytest.mark.parametrize("case", sorted(SSAO_CASES))
def test_ssao_kernel_cases(dev, case):
    """K2 equals `ssao_taps_plain` bit for bit at every shape and tap
    count: widths off the block and the tap group, odd full-resolution
    sizes, one pixel, 1 / 7 / 26 / 64 taps (the generic instantiation
    and the 26-tap one), a radius that throws most taps off the screen
    (they clamp to the border texels), zeroed w rows (both `!= 0`
    guards), a depth of all 1.0."""
    h, w, H, W, k, kw = SSAO_CASES[case]
    kw = dict(kw)
    if kw.get("depth") == "ones":
        kw["depth"] = torch.ones(H, W)
    args = _ssao_inputs(dev, h, w, H, W, k, seed=len(case), **kw)
    got = ssao.ssao_taps(*args)
    want = ssao.ssao_taps(*args, impl="plain")
    torch.cuda.synchronize()
    assert got.shape == (h, w)
    assert torch.equal(got, want), (got - want).abs().max().item()
    if case == "taps_leave_the_screen":
        planes, depth, proj, _, radius, _, kern = args
        s = planes[0:3, None] + (planes[3:6, None] * kern[:, 0, None, None]
                                 + planes[6:9, None] * kern[:, 1, None, None]
                                 + planes[9:12, None] * kern[:, 2, None, None]
                                 ) * radius
        ow = proj[3, 0] * s[0] + proj[3, 1] * s[1] + proj[3, 2] * s[2] \
            + proj[3, 3]
        u = (proj[0, 0] * s[0] + proj[0, 2] * s[2]) / ow * 0.5 + 0.5
        v = (proj[1, 1] * s[1] + proj[1, 2] * s[2]) / ow * 0.5 + 0.5
        off = (u < 0) | (u > 1) | (v < 0) | (v > 1)
        assert float(off.float().mean()) > 0.5


@pytest.mark.parametrize("k", [0, 65])
def test_ssao_kernel_refuses_tap_counts(dev, k):
    args = list(_ssao_inputs(dev, 8, 8, 16, 16, 26))
    args[6] = torch.zeros(k, 3, device=dev)
    with pytest.raises(ValueError):
        ssao.ssao_taps(*args)


def test_ssao_call_does_not_wait_for_the_card(dev):
    """`ssao_generate` (cached kernel vectors and noise constant, the
    parameter block made on the device) enqueued behind a sleeping
    kernel returns before the sleep ends."""
    import time
    H, W = 128, 256
    cam = Camera3D()
    cam.resize(W, H)
    g = ShaderGlobals.create(
        camera=camera_matrices(cam, [0.0, 2.0, 0.0], 1, W, H), device=dev)
    gen = torch.Generator(device="cpu").manual_seed(5)
    depth = (torch.rand(H, W, generator=gen) * 0.2 + 0.79).to(dev)
    normal = torch.nn.functional.normalize(
        torch.randn(3, H, W, generator=gen), dim=0).to(dev)
    ssao.ssao_generate(depth, normal, g)     # build, caches
    torch.cuda.synchronize()
    done = torch.cuda.Event()
    torch.cuda._sleep(1 << 28)               # ~0.14 s at 1.98 GHz
    t0 = time.perf_counter()
    ssao.ssao_generate(depth, normal, g)
    host = time.perf_counter() - t0
    done.record()
    assert not done.query(), "the sleep ended before the check"
    torch.cuda.synchronize()
    assert host < 0.1


def test_taa_kernel_matches_plain(dev):
    g = torch.Generator(device="cpu").manual_seed(1)
    H, W = 72, 136
    hist = (torch.rand(5, H, W, generator=g) * 3).to(torch.bfloat16).to(dev)
    vel = ((torch.rand(2, H, W, generator=g) - 0.5) * 0.2).to(dev)
    k = taa.reproject_history(hist, vel)
    p = taa.reproject_history(hist, vel, impl="plain")
    torch.cuda.synchronize()
    assert torch.equal(k, p)


@pytest.mark.parametrize("C,H,W,speed", [(5, 37, 53, 0.2), (5, 1, 1, 0.2),
                                         (5, 48, 64, 3.0), (7, 29, 70, 3.0)])
def test_taa_kernel_edges_match_plain(dev, C, H, W, speed):
    """K3 at widths that are no multiple of 4 or of a warp's 32 pixels
    (ragged blocks, odd planes), at 1x1, and with velocities that throw
    taps past all four borders, with the packed history's 5 channels
    and with 7."""
    g = torch.Generator(device="cpu").manual_seed(H * W + C)
    hist = (torch.rand(C, H, W, generator=g) * 3).to(torch.bfloat16).to(dev)
    vel = ((torch.rand(2, H, W, generator=g) - 0.5) * 2 * speed).to(dev)
    k = taa.reproject_history(hist, vel)
    p = taa.reproject_history(hist, vel, impl="plain")
    torch.cuda.synchronize()
    assert torch.equal(k, p)
    if speed > 1:
        from soc_real_time_renderer_tpu_torch.ops import sampling
        uv = sampling.grid_uv(H, W, dev) - vel
        for a in (0, 1):
            assert bool((uv[a] < 0).any()) and bool((uv[a] > 1).any())


def _taa_inputs(dev, V=(), H=64, W=96, seed=0, speed=0.02, fc=(7,),
                nan=False):
    """Seeded TAA inputs on `dev`: colour, depth, velocity (uv units, each
    component within +-speed), the bf16 history (its velocity 0.9 or -3
    times the current, so some pixels disocclude) and the frame counter
    (fc: one per view, or one for all); nan: a NaN texel in the colour,
    the previous colour and the previous velocity."""
    g = torch.Generator(device="cpu").manual_seed(seed)

    def rand(*shape):
        return torch.rand(*V, *shape, generator=g)

    color = rand(3, H, W) ** 2 * 3
    depth = rand(H, W)
    vel = (rand(2, H, W) - 0.5) * 2 * speed
    pc = (rand(3, H, W) * 3).to(torch.bfloat16)
    pv = (vel * torch.where(rand(2, H, W) < 0.7, 0.9, -3.0)).to(
        torch.bfloat16)
    if nan:
        color[..., 1, H // 2, W // 3] = float("nan")
        pc[..., 0, H // 3, W // 2] = float("nan")
        pv[..., 1, H // 4, W // 5] = float("nan")
    counter = torch.tensor(fc if V else fc[0], dtype=torch.int32)
    return [x.to(dev) for x in (color, depth, vel, pc, pv, counter)]


def _same(k, p):
    """max abs 0, NaN at the same places."""
    nan = torch.isnan(p)
    assert torch.equal(torch.isnan(k), nan)
    assert torch.equal(k[~nan], p[~nan])


TAA_CASES = {   # the benchmark's size, ragged sizes, uv off the screen,
    #             NaN texels, frame counter 0, two views in one launch
    "bench_1920x1088": dict(H=1088, W=1920, seed=1),
    "ragged_97x61_first_frame": dict(H=61, W=97, seed=2, fc=(0,)),
    "one_pixel": dict(H=1, W=1, seed=3),
    "off_screen": dict(H=64, W=96, seed=4, speed=1.5),
    "nan_texels": dict(H=61, W=97, seed=5, nan=True),
    "two_views": dict(V=(2,), H=72, W=136, seed=6, fc=(0, 7), speed=0.3),
}


@pytest.mark.parametrize("case", sorted(TAA_CASES))
def test_taa_resolve_kernel_matches_plain(dev, case):
    """K3f, the fused resolve: one launch (K3 not launched) that equals
    taa(impl="plain") bit for bit, NaN at the same pixels."""
    spec = TAA_CASES[case]
    args = _taa_inputs(dev, **spec)
    before = dict(kb.launches)
    k = taa.taa(*args)
    assert kb.launches["taa_resolve"] == before["taa_resolve"] + 1
    assert kb.launches["taa_reproject"] == before["taa_reproject"]
    p = taa.taa(*args, impl="plain")
    torch.cuda.synchronize()
    assert k.shape == p.shape == (*spec.get("V", ()), 3, spec["H"],
                                  spec["W"])
    _same(k, p)
    if case == "nan_texels":
        assert 9 < int(torch.isnan(p).any(-3).sum()) < p[0].numel() // 4
    if case == "off_screen":
        from soc_real_time_renderer_tpu_torch.ops import sampling
        uv = sampling.grid_uv(spec["H"], spec["W"], dev) - args[2]
        assert bool(((uv < 0) | (uv > 1)).any())


@pytest.mark.parametrize("views", [0, 2])
def test_taa_resolve_bands_match_unsplit(dev, views):
    """taa() in two row bands over a ["cuda:0"] * 2 mesh (each band's
    colour, depth and velocity with a 1-row halo, crop 1, the whole
    history): K3f once a band, each band equal to its plain version and
    the joined bands to the unsplit frame, with velocities that fetch
    across the band border and off the screen."""
    from soc_real_time_renderer_tpu_torch.parallel import halo
    from soc_real_time_renderer_tpu_torch.parallel import mesh as pmesh
    V = (views,) if views else ()
    *images, fc = _taa_inputs(dev, V, H=72, W=136, seed=7 + views,
                              speed=0.3, fc=(3, 0)[:views or 1])
    whole = taa.taa(*images, fc)
    mesh = pmesh.make_mesh(2, dp=1, devices=[dev] * 2)
    bands = [halo.split_rows(x, mesh.band_devices("sp")) for x in images]
    before = dict(kb.launches)
    k = taa.taa(*bands, fc, shard=(mesh, "sp"))
    assert kb.launches["taa_resolve"] == before["taa_resolve"] + 2
    assert kb.launches["taa_reproject"] == before["taa_reproject"]
    p = taa.taa(*bands, fc, impl="plain", shard=(mesh, "sp"))
    torch.cuda.synchronize()
    assert [b.shape[-2] for b in k] == [36, 36]
    for a, b in zip(k, p):
        _same(a, b)
    _same(halo.assemble(k, dev), whole)


@pytest.mark.parametrize("name", ["full_nohelmet", "atrium_lifted"])
def test_taa_resolve_on_a_frames_inputs(dev, name):
    """K3f on the hdr, depth, velocity and bf16 history of the second
    frame of a small scene (recorded from the plain frame as
    chip_smoke.py records them): equal to its plain version."""
    import chip_smoke
    built = kit.build_port(name, RenderConfig(width=256, height=128,
                                              shadow_resolution=512), dev)
    hist = fm.RenderHistory.create(built.plan.config, device=dev)
    g, mm, nm = built.frame_globals(0)
    _, hist = fm.render_frame(built.plan, built.batch, g, hist, mm, nm,
                              impl="plain")
    g, mm, nm = built.frame_globals(1)
    seen = chip_smoke.recorded_inputs(lambda: fm.render_frame(
        built.plan, built.batch, g, hist, mm, nm, impl="plain"))
    fn, a, kw = seen["taa_resolve"]
    assert a[3].abs().amax() > 0 and int(a[5]) == 1
    k, p = fn(*a, impl="cuda", **kw), fn(*a, impl="plain", **kw)
    torch.cuda.synchronize()
    _same(k, p)


def test_small_frame_kernel_path_matches_plain(dev):
    hm = terrain.procedural_heightmap(64)
    model = terrain.build_terrain_model(hm, terrain.default_albedo(hm),
                                        tess_level=1)
    scene = Scene("terrain")
    e = scene.create_entity("terrain")
    e.add_component(TransformComponent())
    e.add_component(MeshComponent()).model = model
    built = scenes._finish(scene, [model], RenderConfig(width=256, height=128),
                           [20.0, 12.0, 20.0], [50, 0, 50], device=dev,
                           atlas_size=64)
    hk = hp = fm.RenderHistory.create(built.plan.config, device=dev)
    kb.reset_launches()
    for f in range(3):
        g, mm, nm = built.frame_globals(f)
        ok, hk = fm.render_frame(built.plan, built.batch, g, hk, mm, nm)
        op, hp = fm.render_frame(built.plan, built.batch, g, hp, mm, nm,
                                 impl="plain")
    torch.cuda.synchronize()
    assert kb.launches == {"resolve": 3, "resolve_depth": 0, "texsample": 0,
                           "ssao_taps": 3, "sky_lut": 0,
                           "sky_lut_procedural": 3, "taa_reproject": 0,
                           "taa_resolve": 3, "local_lights": 0,
                           "ssr_march": 0, "gbuffer_resolve": 3}
    assert not kb.variant_launches
    assert torch.isfinite(ok.color).all()
    assert (ok.color - op.color).abs().max().item() < 1e-5


@pytest.mark.parametrize("S", [512, 1024])
def test_resolve_depth_kernel_matches_plain(dev, S):
    """K4 on a soup seen as a shadow view (128-px bins, back-face cull):
    bit-identical to resolve_depth_plain, empty bins included."""
    dk, _ = _depth_both(_soup(400, S, S, S).to(dev), S, _shadow_grid(S))
    assert 0.05 < (dk < 1.0).float().mean().item() < 1.0


def test_resolve_kernels_keep_a_sliver_inside_its_box(dev):
    """The lifted atrium's sliver (kit.LIFTED_SLIVER), whose float32 edge
    functions pass at texels (1971, 2190) and (1971, 2191) past its box:
    K4 and K1 bit-identical to their plain versions, and neither covers
    a texel outside the box."""
    S = 4096
    clip = kit.sliver_clip().to(dev)
    dk, _ = _depth_both(clip, S, _shadow_grid(S))
    setup = raster2.triangle_setup_planar(clip, S, S, "back")
    ik, _ = _resolve_both(setup, raster2.BinGrid(
        width=S, height=S, bin_w=64, bin_h=32, group=2, pair_cap=65536,
        med_cap=512))
    for covered in (dk < 1.0, ik >= 0):
        ys, xs = torch.nonzero(covered, as_tuple=True)
        assert len(ys) and bool(((ys >= 2182) & (ys < 2190)).all())
        assert bool(((xs >= 1971) & (xs < 1973)).all())


def _depth_both(clip, S, grid):
    """K4 and resolve_depth_plain on the clip triangles seen as a shadow
    view (back-face cull): asserts one launch and bit-identical depth;
    returns (depth, starts)."""
    setup = raster2.triangle_setup_planar(clip, S, S, "back")
    starts, recs, _, rgrid = raster2.gather_records(setup, grid)
    n0 = kb.launches["resolve_depth"]
    dk = raster2.resolve_depth(starts, recs, rgrid)
    assert kb.launches["resolve_depth"] == n0 + 1
    dp = raster2.resolve_depth(starts, recs, rgrid, impl="plain")
    torch.cuda.synchronize()
    assert dk.shape == (rgrid.by * rgrid.bh, rgrid.bx * rgrid.bw)
    assert torch.equal(dk, dp)
    return dk, starts


def _shadow_grid(S, **kw):
    grid = raster2.default_grid(S, S, kind="shadow")
    return raster2.BinGrid(**{**grid.__dict__, "pair_cap": 65536,
                              "med_cap": 512, **kw})


def _heavy_bin_clip(n=25_000, seed=9):
    """n small triangles over the whole clip square, w in [0.5, 2]."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1, 1, (n, 1, 2)) + rng.uniform(-0.15, 0.15, (n, 3, 2))
    wv = rng.uniform(0.5, 2.0, (n, 1, 1)).repeat(3, axis=1)
    z = rng.uniform(0.05, 0.95, (n, 3, 1))
    clip = np.concatenate([xy * wv, z * wv, wv], axis=2).astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(clip.transpose(1, 2, 0)))


@pytest.mark.parametrize("case", ["heavy_bin", "slivers", "empty", "behind",
                                  "bins96", "bins80"])
def test_resolve_depth_kernel_cases(dev, case):
    """K4 bit-identical to resolve_depth_plain on: one 128x128 bin of
    more than 10,000 pairs (25,000 triangles of both facings, back-face
    culled), so each block of the bin walks dozens of windows; the raster
    oracle's slivers on 128-px bins; a view with no pair at all (the
    clear alone); a view whose only pairs lie wholly behind the camera
    (all in bin 0, covering nothing); and 96x96 and 80x80 bins on a
    480^2 target: bin widths that do not divide 256, the second cut by
    the block's 32-pixel regions into ragged parts."""
    if case == "heavy_bin":
        grid = _shadow_grid(128, pair_cap=32768)
        dk, starts = _depth_both(_heavy_bin_clip().to(dev), 128, grid)
        assert grid.num_bins == 1 and int(starts[-1]) >= 10_000
        assert (dk < 1.0).float().mean() > 0.9
    elif case == "slivers":
        clip = _soup(60, 2, 256, 256, squash=(1.0, 0.02, 1.0)).to(dev)
        # both windings: the cull keeps about half of them
        clip = torch.cat([clip, clip[[0, 2, 1]]], dim=2)
        dk, _ = _depth_both(clip, 256, _shadow_grid(256))
        assert int((dk < 1.0).sum()) > 100
    elif case == "empty":
        clip = _soup(50, 3, 512, 512).to(dev)
        clip[1:] = clip[:1]                       # zero area: all invalid
        dk, starts = _depth_both(clip, 512, _shadow_grid(512))
        assert int(starts[-1]) == 0 and bool((dk == 1.0).all())
    elif case == "behind":
        clip = _soup(200, 3, 512, 512).to(dev)
        clip[:, 3] = -clip[:, 3].abs() - 1.0      # every w < 0
        dk, starts = _depth_both(clip, 512, _shadow_grid(512))
        assert int(starts[-1]) == int(starts[1]) > 0
        assert bool((dk == 1.0).all())
    else:
        grid = raster2.BinGrid(width=480, height=480, bin_size=int(case[4:]),
                               group=1, pair_cap=65536, med_cap=512)
        clip = _soup(400, 96, 480, 480).to(dev)
        dk, _ = _depth_both(clip, 480, grid)
        assert dk.shape == (480, 480)
        assert 0.05 < (dk < 1.0).float().mean().item() < 1.0


def _toy_atlas(M=3, size=64, seed=0):
    rng = np.random.default_rng(seed)
    n_levels = int(np.log2(size)) + 1
    stride = sum((size >> k) ** 2 for k in range(n_levels))
    packed = rng.integers(0, 256, (16, M * stride), dtype=np.uint8)
    return PackedMaterialAtlas(packed=packed, size=size, num_materials=M,
                               layer_stride=stride, n_levels=n_levels)


@pytest.mark.parametrize("mode", ["bilinear", "nearest", "trilinear"])
def test_texsample_kernel_matches_plain(dev, mode):
    """K5 on a random 3-material atlas at random (mid, uv, lod), uv
    wrapping through negative values: max abs <= 1e-6."""
    atlas = _toy_atlas()
    table = torch.from_numpy(expand_atlas_bilinear(atlas)).to(dev)
    rng = np.random.default_rng(3)
    n = 50_000
    mid = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)).to(dev)
    uv = torch.from_numpy(rng.uniform(-3, 4, (2, n)).astype(np.float32)
                          ).to(dev)
    lod = torch.from_numpy(rng.uniform(-1, 8, n).astype(np.float32)).to(dev)
    kw = dict(size=atlas.size, layer_stride=atlas.layer_stride,
              n_levels=atlas.n_levels, filter_mode=mode)
    k = texsample.sample_atlas(table, mid, uv, lod, **kw)
    p = texsample.sample_atlas(table, mid, uv, lod, impl="plain", **kw)
    torch.cuda.synchronize()
    assert (k - p).abs().max().item() <= 1e-6


def test_texsample_kernel_asserts_past_the_atlas(dev):
    """A mid past the atlas's last material is a device-side assert, as
    the plain version's gather is on the card, not a clamped read of
    another material.  In a child process: the assert ends its CUDA
    context."""
    code = textwrap.dedent("""
        import numpy as np, torch
        from soc_real_time_renderer_tpu_torch.models.texture import \\
            PackedMaterialAtlas, expand_atlas_bilinear
        from soc_real_time_renderer_tpu_torch.ops import texsample
        packed = np.zeros((16, 3 * 5461), np.uint8)
        atlas = PackedMaterialAtlas(packed=packed, size=64, num_materials=3,
                                    layer_stride=5461, n_levels=7)
        table = torch.from_numpy(expand_atlas_bilinear(atlas)).cuda()
        mid = torch.tensor([0, 3], dtype=torch.int32, device="cuda")
        uv = torch.full((2, 2), 0.25, device="cuda")
        lod = torch.zeros(2, device="cuda")
        texsample.sample_atlas(table, mid, uv, lod, size=64,
                               layer_stride=5461, n_levels=7)
        torch.cuda.synchronize()
        print("no error")
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode != 0 and "no error" not in res.stdout
    assert "device-side assert" in res.stderr, res.stderr[-2000:]


def _tap_inputs(dev, n, seed=3):
    atlas = _toy_atlas()
    table = torch.from_numpy(expand_atlas_bilinear(atlas)).to(dev)
    rng = np.random.default_rng(seed)
    mid = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)).to(dev)
    uv = torch.from_numpy(rng.uniform(-3, 4, (2, n)).astype(np.float32)
                          ).to(dev)
    lod = torch.from_numpy(rng.uniform(-1, 8, n).astype(np.float32)).to(dev)
    return (table, mid, uv, lod), dict(size=atlas.size,
                                       layer_stride=atlas.layer_stride,
                                       n_levels=atlas.n_levels)


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "trilinear"])
@pytest.mark.parametrize("n", [1, 3, 5, 1029, 50_001])
def test_texsample_full_variants_match_plain(dev, mode, n):
    """Every K5 variant that computes the whole tap and stores all of it
    (planar, interleaved f32 and bf16, the 3-lane split, 2 and 4 pixels a
    thread) equals its plain version bit for bit: the interleaved ones
    the plain tap transposed with lane 11 zero, bf16 that cast with
    PyTorch's round to nearest even; at P = 1, 3, 5 and sizes that no
    pixel group (256, 512, 1024 pixels; 64 and 256 lane groups)
    divides.  One launch each, counted under the variant, none as K5."""
    args, kw = _tap_inputs(dev, n)
    kb.reset_launches()
    full = [name for name, v in texsample.VARIANTS.items() if v.full]
    for name in full:
        k = texsample.sample_atlas_variant(*args, variant=name,
                                           filter_mode=mode, **kw)
        p = texsample.sample_atlas_variant(*args, variant=name,
                                           filter_mode=mode, impl="plain",
                                           **kw)
        torch.cuda.synchronize()
        assert k.dtype == p.dtype and k.shape == p.shape, name
        assert torch.equal(k, p), (name, (k.float() - p.float()).abs().max())
    assert dict(kb.variant_launches) == {name: 1 for name in full}
    assert kb.launches["texsample"] == 0


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "trilinear"])
def test_texsample_ablated_variants_launch_once(dev, mode):
    """Each timing-only variant (a stage switched off, or one f32 a pixel
    stored) launches once a call and runs without a fault, at a size no
    pixel group divides; its output has its store's shape."""
    args, kw = _tap_inputs(dev, 50_001)
    kb.reset_launches()
    ablated = [name for name, v in texsample.VARIANTS.items() if not v.full]
    for name in ablated:
        out = texsample.sample_atlas_variant(*args, variant=name,
                                             filter_mode=mode, **kw)
        torch.cuda.synchronize()
        assert out.shape == (50_001,) or out.shape == (11, 50_001), name
    assert dict(kb.variant_launches) == {name: 1 for name in ablated}
    assert kb.launches["texsample"] == 0


def test_texture_benches_on_the_card(dev, tmp_path):
    """The capture and the three texture-tap benches on the small
    terrain at 256x128: the capture equals the frame's tap inputs; every
    full variant at max abs 0 in the benches; each run's variant
    launched; registers, LDG and STG read for every variant's kernel,
    with loads and stores kept; K5's rows in bench_texsample."""
    from soc_real_time_renderer_tpu_torch.tools import bench_texkernel_parts, \
        bench_texmm2, bench_texsample, capture_texfields
    hm = terrain.procedural_heightmap(64)
    model = terrain.build_terrain_model(hm, terrain.default_albedo(hm),
                                        tess_level=1)
    scene = Scene("terrain")
    e = scene.create_entity("terrain")
    e.add_component(TransformComponent())
    e.add_component(MeshComponent()).model = model
    built = scenes._finish(scene, [model], RenderConfig(width=256, height=128),
                           [20.0, 12.0, 20.0], [50, 0, 50], device=dev,
                           atlas_size=64)
    size = ["--width", "256", "--height", "128", "--fields",
            str(tmp_path / "f.npz")]
    fields = capture_texfields.main(size[:4] + ["--out", size[5]],
                                    built=built)
    assert 0 < fields["live"].mean() <= 1
    rows = bench_texsample.main(size + ["--reps", "3"], built=built)
    assert all(r["device_ms"] > 0 for r in rows if r["label"][:2] == "K5")
    for tool, n in ((bench_texkernel_parts, 16), (bench_texmm2, 7)):
        kb.reset_launches()
        rows = tool.main(size + ["--reps", "3"], built=built)
        assert len(rows) == n
        assert set(kb.variant_launches) == {r["variant"] for r in rows}
        for r in rows:
            assert r["device_ms"] > 0 and r["ms"] > 0, r
            assert r["registers"] and r["LDG"] > 0 and r["STG"] > 0, r
            if r["full"] and "+" not in r["label"]:
                assert r["max_abs_err"] == 0.0, r


# --- K9, the G-buffer resolve (ops/gbuffer.py, kernels/csrc/gbuffer.cu) --

GBUFFER_TARGETS = ("albedo", "emissive", "normal", "metallic_roughness",
                   "velocity", "depth")


def _small_terrain(dev, width=256, height=128):
    """The reduced terrain (64^2 heightmap, one material, sky pixels) at
    width x height, built on the card."""
    hm = terrain.procedural_heightmap(64)
    model = terrain.build_terrain_model(hm, terrain.default_albedo(hm),
                                        tess_level=1)
    scene = Scene("terrain")
    e = scene.create_entity("terrain")
    e.add_component(TransformComponent())
    e.add_component(MeshComponent()).model = model
    return scenes._finish(scene, [model], RenderConfig(width=width,
                                                       height=height),
                          [20.0, 12.0, 20.0], [50, 0, 50], device=dev,
                          atlas_size=64)


def _gbuffer_inputs(built, g=None, mm=None, nm=None):
    """(vis, records, atlas, prev_view_proj, size keywords) of frame 1 of
    `built` (or of the globals given)."""
    if g is None:
        g, mm, nm = built.frame_globals(1)
    vis, recs, _, _ = fm.raster_stage(built.plan, built.batch, g, mm, nm)
    plan = built.plan
    return (vis, recs, built.batch.atlas_packed,
            g.camera_prev.projection_view,
            dict(atlas_size=plan.atlas_size,
                 layer_stride=plan.atlas_layer_stride,
                 n_levels=plan.atlas_n_levels))


def _gbuffer_both(vis, recs, atlas, vp, kw, mode="bilinear", **band):
    """K9 and the plain resolve_gbuffer on the same inputs: one K9 launch,
    no K5 launch, every target bit for bit (NaN at the same places) in
    the plain version's shape, each of K9's five stored planar (C, *V,
    H, W) and dense, as the frame's path stored them through K5.
    Returns K9's G-buffer."""
    from soc_real_time_renderer_tpu_torch.ops import gbuffer
    n0 = dict(kb.launches)
    k = gbuffer.resolve_gbuffer(vis, recs, atlas, vp, filter_mode=mode,
                                **kw, **band)
    assert kb.launches["gbuffer_resolve"] == n0["gbuffer_resolve"] + 1
    assert kb.launches["texsample"] == n0["texsample"]
    p = gbuffer.resolve_gbuffer(vis, recs, atlas, vp, filter_mode=mode,
                                impl="plain", **kw, **band)
    torch.cuda.synchronize()
    assert {n: v for n, v in kb.launches.items() if n != "gbuffer_resolve"} \
        == {n: v for n, v in n0.items() if n != "gbuffer_resolve"}
    nv = vis.tri_id.dim() - 2
    for name in GBUFFER_TARGETS:
        a, b = getattr(k, name), getattr(p, name)
        assert a.shape == b.shape, name
        assert name == "depth" or a.movedim(nv, 0).is_contiguous(), name
        _same(a, b)
    return k


@pytest.mark.parametrize("scene", ["terrain", "full_nohelmet"])
@pytest.mark.parametrize("mode", ["nearest", "bilinear", "trilinear", "none"])
def test_gbuffer_kernel_matches_plain(dev, scene, mode):
    """K9 on frame 1 of the reduced terrain (one material, the terrain
    branch, sky pixels) and of the small full_nohelmet (six materials
    and the terrain, TBN, velocity) at 256x128, in each filter mode and
    the probe "none": one launch, bit for bit the plain version."""
    built = (_small_terrain(dev) if scene == "terrain" else
             kit.build_port("full_nohelmet",
                            RenderConfig(width=256, height=128), dev))
    vis, recs, atlas, vp, kw = _gbuffer_inputs(built)
    live = (vis.tri_id >= 0).float().mean().item()
    assert (0.05 < live < 0.95) if scene == "terrain" else live > 0.5
    k = _gbuffer_both(vis, recs, atlas, vp, kw, mode)
    assert torch.isfinite(k.albedo).all() and torch.isfinite(k.normal).all()


def test_gbuffer_kernel_takes_four_views_in_one_launch(dev):
    """Four views of the small atrium_lifted from distinct cameras in one
    K9 launch (views on blockIdx.z, each its own adjugate rows and
    prev_view_proj): bit for bit the plain version, and each view equals
    K9 on that view alone."""
    built = kit.build_port("atrium_lifted",
                           RenderConfig(width=256, height=128,
                                        shadow_resolution=512), dev)
    gb, _, mm, nm = _views(built, 4)
    vis, recs, atlas, vp, kw = _gbuffer_inputs(built, gb, mm, nm)
    assert vis.tri_id.shape == (4, 128, 256) and vp.shape == (4, 4, 4)
    k = _gbuffer_both(vis, recs, atlas, vp, kw, "trilinear")
    assert not torch.equal(k.normal[0], k.normal[1])
    for i in range(4):
        one = _gbuffer_both(
            raster2.VisibilityBuffer(depth=vis.depth[i],
                                     tri_id=vis.tri_id[i],
                                     overflow=vis.overflow[i]),
            recs[:, i], atlas, vp[i], kw, "trilinear")
        for name in GBUFFER_TARGETS:
            assert torch.equal(getattr(k, name)[i], getattr(one, name)), name


def test_gbuffer_kernel_bands_equal_the_whole_screen(dev):
    """Two row bands of full_nohelmet's frame (row0, full_h), each one K9
    launch against its plain version, together equal to the whole
    screen's K9 call bit for bit."""
    built = kit.build_port("full_nohelmet",
                           RenderConfig(width=256, height=128), dev)
    vis, recs, atlas, vp, kw = _gbuffer_inputs(built)
    whole = _gbuffer_both(vis, recs, atlas, vp, kw)
    for a, b in ((0, 68), (68, 128)):
        band = raster2.VisibilityBuffer(depth=vis.depth[a:b],
                                        tri_id=vis.tri_id[a:b],
                                        overflow=vis.overflow)
        got = _gbuffer_both(band, recs, atlas, vp, kw, row0=a, full_h=128)
        for name in GBUFFER_TARGETS:
            assert torch.equal(getattr(got, name),
                               getattr(whole, name)[..., a:b, :]), name


@pytest.mark.parametrize("mode", ["bilinear", "trilinear"])
def test_gbuffer_kernel_hand_built_records(dev, mode):
    """K9 on hand-built records (torch_scene_kit.hand_gbuffer_inputs: D ==
    0, pc_w == 0, a zero tangent, the terrain branch, an all-miss block)
    over a random 3-material atlas: bit for bit the plain version; the
    miss block is the sky clear."""
    atlas = _toy_atlas()
    table = torch.from_numpy(expand_atlas_bilinear(atlas)).to(dev)
    vis, rec, vp = kit.hand_gbuffer_inputs(dev)
    kw = dict(atlas_size=atlas.size, layer_stride=atlas.layer_stride,
              n_levels=atlas.n_levels)
    k = _gbuffer_both(vis, rec, table, vp, kw, mode)
    sky = torch.tensor([0.2, 0.4, 1.0], device=dev)[:, None, None]
    assert torch.equal(k.albedo[:, 8:16, 32:64],
                       sky.expand(3, 8, 32))
    assert not k.velocity[:, 8:16, 32:64].any()
    assert torch.isfinite(k.normal).all() and torch.isfinite(k.velocity).all()


def test_gbuffer_call_does_not_wait_for_the_card(dev):
    """resolve_gbuffer enqueued behind a sleeping kernel returns before
    the sleep ends: K9's wrapper makes no blocking copy or read."""
    import time
    from soc_real_time_renderer_tpu_torch.ops import gbuffer
    built = _small_terrain(dev)
    vis, recs, atlas, vp, kw = _gbuffer_inputs(built)
    gbuffer.resolve_gbuffer(vis, recs, atlas, vp, **kw)     # build
    torch.cuda.synchronize()
    done = torch.cuda.Event()
    torch.cuda._sleep(1 << 28)               # ~0.14 s at 1.98 GHz
    t0 = time.perf_counter()
    gbuffer.resolve_gbuffer(vis, recs, atlas, vp, **kw)
    host = time.perf_counter() - t0
    done.record()
    assert not done.query(), "the sleep ended before the check"
    torch.cuda.synchronize()
    assert host < 0.1


SKY_CASES = {
    # name: (lut_w, lut_h, sun direction or None, elapsed time, noise)
    "frame": (256, 128, None, 3.0, "field"),
    "ragged_100x37": (100, 37, None, 3.0, "field"),
    "sun_below_horizon": (256, 128, (0.3, 0.5, -0.2), 3.0, "field"),
    "sun_at_zenith": (256, 128, (0.0, -1.0, 0.0), 3.0, "field"),
    "elapsed_ten_minutes": (256, 128, None, 600.0, "field"),
    "elapsed_ten_hours": (256, 128, None, 36000.0, "field"),
    "noise_all_zero": (128, 64, None, 3.0, 0.0),
    "noise_all_one": (128, 64, None, 3.0, 1.0),
}


@pytest.mark.parametrize("case", sorted(SKY_CASES))
def test_sky_kernel_matches_plain(dev, case):
    """K6 bit-identical to its plain version (the plain version's order
    and functions, see sky.cu): at the frame's 256x128 LUT; at a LUT
    size that no block or warp count divides; with the sun below the
    horizon (SunInfo.direction points from the sun, so y > 0) and at the
    zenith; at ten minutes and ten hours of elapsed time (the cloud
    drift, and the atmosphere march's start offset, the reference's
    iTime quirk: minutes in, it starts the lowest rays under the ground,
    where the plain version's own result is NaN, and the kernel must
    give NaN at the same texels); and over constant noise fields, where
    no march sample holds cloud (0) or every sample inside the shell
    does (1)."""
    lut_w, lut_h, sun, elapsed, field = SKY_CASES[case]
    g = _sky_globals(dev, sun, elapsed)
    if field == "field":
        noise = torch.from_numpy(kit.cloud_noise()).to(dev)
    else:
        noise = torch.full((64, 64), field, device=dev)
    n0 = kb.launches["sky_lut"]
    k = sky.render_sky_lut_noise(g, noise, lut_w, lut_h)
    assert kb.launches["sky_lut"] == n0 + 1
    p = sky.render_sky_lut_noise(g, noise, lut_w, lut_h, impl="plain")
    torch.cuda.synchronize()
    assert k.shape == (3, lut_h, lut_w)
    nan = torch.isnan(p)
    assert not bool(nan.any()) or case.startswith("elapsed")
    assert torch.isfinite(p[~nan]).all() and not bool(nan.all())
    assert torch.equal(torch.isnan(k), nan)
    assert torch.equal(k[~nan], p[~nan])
    ref = clouds.render_sky_lut(g, lut_w, lut_h, noise_tex=noise)
    assert torch.equal(p[~nan], ref[~nan])
    if field == "field" and sun is None:
        # the clouds change the upper half against the cloudless LUT
        bare = sky.render_sky_lut_noise(g, torch.zeros_like(noise), lut_w,
                                        lut_h)
        assert not torch.equal(bare, k)


def _sky_globals(dev, sun, elapsed, position=(0.0, 2.0, 0.0)):
    """One frame's globals for the sky LUT tests: the camera at
    `position`, `elapsed` seconds, the default sun or one from the
    direction `sun` (normalised)."""
    cam = Camera3D()
    cam.resize(256, 128)
    g = ShaderGlobals.create(
        camera=camera_matrices(cam, list(position), 1, 256, 128),
        elapsed_time=np.float32(elapsed), device=dev)
    if sun is not None:
        d = np.asarray(sun, np.float32)
        d = torch.from_numpy(d / np.linalg.norm(d)).to(dev)
        g = dataclasses.replace(g, sun=dataclasses.replace(g.sun,
                                                           direction=d))
    return g


SKY_PROCEDURAL_CASES = {
    # name: (lut_w, lut_h, sun direction or None, elapsed times, one a view)
    "frame": (256, 128, None, (3.0,)),
    "ragged_100x37": (100, 37, None, (3.0,)),
    "sun_below_horizon": (256, 128, (0.3, 0.5, -0.2), (3.0,)),
    "sun_at_zenith": (256, 128, (0.0, -1.0, 0.0), (3.0,)),
    "elapsed_ten_minutes": (256, 128, None, (600.0,)),
    "elapsed_ten_hours": (256, 128, None, (36000.0,)),
    "four_views": (256, 128, None, (3.0, 41.0, 600.0, 36000.0)),
}


@pytest.mark.parametrize("case", sorted(SKY_PROCEDURAL_CASES))
def test_sky_procedural_kernel_matches_plain(dev, case):
    """K6p bit-identical to its plain version clouds.render_sky_lut(g)
    (the plain version's order and functions, see sky.cu; the hash turns
    a one-ulp difference in sinf into noise), in the cases of
    test_sky_kernel_matches_plain: the frame's 256x128 LUT, a size that
    no block or warp count divides, the sun below the horizon and at the
    zenith, ten minutes and ten hours of elapsed time (NaN texels of the
    plain version NaN in the kernel too); and four views from distinct
    cameras and times in one launch, each view the single view's LUT.
    One launch a call."""
    lut_w, lut_h, sun, times = SKY_PROCEDURAL_CASES[case]
    gs = [_sky_globals(dev, sun, t, (3.0 * i, 2.0 + 5.0 * i, -2.0 * i))
          for i, t in enumerate(times)]
    if len(gs) == 1:
        g = gs[0]
    else:
        from soc_real_time_renderer_tpu_torch.parallel import mesh as pmesh
        g = pmesh.batched_globals(gs)
    n0 = kb.launches["sky_lut_procedural"]
    k = sky.render_sky_lut_procedural(g, lut_w, lut_h)
    assert kb.launches["sky_lut_procedural"] == n0 + 1
    p = sky.render_sky_lut_procedural(g, lut_w, lut_h, impl="plain")
    assert kb.launches["sky_lut_procedural"] == n0 + 1
    torch.cuda.synchronize()
    V = (len(gs),) if len(gs) > 1 else ()
    assert k.shape == (*V, 3, lut_h, lut_w)
    nan = torch.isnan(p)
    assert not bool(nan.any()) or max(times) >= 600.0
    assert torch.isfinite(p[~nan]).all() and not bool(nan.all())
    assert torch.equal(torch.isnan(k), nan)
    assert torch.equal(k[~nan], p[~nan])
    ref = clouds.render_sky_lut(g, lut_w, lut_h)
    assert torch.equal(p[~nan], ref[~nan])
    if V:
        for i, gi in enumerate(gs):
            one = sky.render_sky_lut_procedural(gi, lut_w, lut_h)
            assert torch.equal(torch.isnan(one), torch.isnan(k[i]))
            assert torch.equal(one.nan_to_num(), k[i].nan_to_num()), i
    elif case == "frame":
        # the procedural clouds change the upper half against the
        # cloudless LUT (K6 over an all-zero noise field)
        bare = sky.render_sky_lut_noise(g, torch.zeros((64, 64), device=dev),
                                        lut_w, lut_h)
        assert not torch.equal(bare, k)


def test_sky_call_does_not_wait_for_the_card(dev):
    """A K6 call and a K6p call enqueued behind a sleeping kernel return
    before the sleep ends: the wrappers make no blocking copy of host
    values (their constants are cached per device)."""
    import time
    g = _sky_globals(dev, None, 3.0)
    noise = torch.from_numpy(kit.cloud_noise()).to(dev)
    sky.render_sky_lut_noise(g, noise)       # build, caches
    sky.render_sky_lut_procedural(g)
    torch.cuda.synchronize()
    done = torch.cuda.Event()
    torch.cuda._sleep(1 << 28)               # ~0.14 s at 1.98 GHz
    t0 = time.perf_counter()
    sky.render_sky_lut_noise(g, noise)
    sky.render_sky_lut_procedural(g)
    host = time.perf_counter() - t0
    done.record()
    assert not done.query(), "the sleep ended before the check"
    torch.cuda.synchronize()
    assert host < 0.1


@pytest.mark.parametrize("name", ["full_nohelmet", "atrium_lifted"])
def test_small_scene_kernel_path_matches_plain(dev, name):
    """Three frames of each multi-entity scene (small atrium, 256x128,
    512^2 shadow map, cloud noise): every kernel of the path launches on
    every frame and the colour equals the plain path's within 1e-5."""
    built = kit.build_port(name, RenderConfig(width=256, height=128,
                                              shadow_resolution=512), dev)
    hk = hp = fm.RenderHistory.create(built.plan.config, device=dev)
    kb.reset_launches()
    for f in range(3):
        g, mm, nm = built.frame_globals(f)
        ok, hk = fm.render_frame(built.plan, built.batch, g, hk, mm, nm)
        op, hp = fm.render_frame(built.plan, built.batch, g, hp, mm, nm,
                                 impl="plain")
    torch.cuda.synchronize()
    want = {"resolve": 3, "texsample": 0, "ssao_taps": 3, "sky_lut": 3,
            "sky_lut_procedural": 0, "taa_reproject": 0,
            "taa_resolve": 3, "local_lights": 0, "ssr_march": 0,
            "gbuffer_resolve": 3,
            "resolve_depth": 0 if name == "full_nohelmet" else 3}
    assert kb.launches == want
    assert torch.isfinite(ok.color).all()
    assert (ok.color - op.color).abs().max().item() < 1e-5


def test_passes_scene_on_the_card(dev):
    """Two frames of the reduced `atrium_passes` scene (metallic floor;
    SSR composited, depth of field, volumetric light over the rendered
    512^2 map) through the kernels: all six launch on every frame, the
    colour equals the plain path's within 1e-5, the compacted SSR target
    equals the dense one bit for bit, and a cap at half of the
    reflective pixels sets bit 16.  K8 launches once a frame; K6p never
    (the scene has the noise texture)."""
    cfg = RenderConfig(width=256, height=128, shadow_resolution=512,
                       enable_ssr=True, composite_ssr=True,
                       enable_depth_of_field=True,
                       enable_volumetric_light=True)
    built = kit.build_port("atrium_passes", cfg, dev)
    g, mm, nm = built.frame_globals(0)
    hist = fm.RenderHistory.create(cfg, device=dev)
    dense, _ = fm.render_frame(dataclasses.replace(built.plan, ssr_cap=0),
                               built.batch, g, hist, mm, nm)
    n = int(dense.gbuffer.metallic_roughness[1].ge(ssr.METALLIC_MIN).sum())
    assert n > 0.01 * 256 * 128
    plan = dataclasses.replace(built.plan, ssr_cap=n + 100)
    hk = hp = hist
    kb.reset_launches()
    for f in range(2):
        g, mm, nm = built.frame_globals(f)
        ok, hk = fm.render_frame(plan, built.batch, g, hk, mm, nm)
        op, hp = fm.render_frame(plan, built.batch, g, hp, mm, nm,
                                 impl="plain")
        if f == 0:
            assert int(ok.ssr_active) == n and int(ok.overflow) == 0
            assert torch.equal(ok.ssr, dense.ssr)
            assert torch.equal(ok.color, dense.color)
    torch.cuda.synchronize()
    assert kb.launches == {k: (0 if k in OFF_FRAME and k != "ssr_march"
                               else 2) for k in kb.launches}
    assert torch.isfinite(ok.color).all()
    assert (ok.color - op.color).abs().max().item() < 1e-5
    g, mm, nm = built.frame_globals(0, peek=True)
    half = dataclasses.replace(built.plan, ssr_cap=n // 2)
    tight, _ = fm.render_frame(half, built.batch, g, hist, mm, nm)
    assert int(tight.overflow) == ssr.OVERFLOW_SSR_CAP


def test_perpixel_clouds_on_the_card(dev):
    """The per-pixel cloud march on the reduced terrain: neither K6 nor
    K6p launches, the clouds target is finite where the camera sees sky, and
    the row chunking is exact on the card."""
    cfg = RenderConfig(width=256, height=128, shadow_resolution=512,
                       cloud_impl="perpixel")
    built = kit.build_port("terrain_perpixel", cfg, dev)
    g, mm, nm = built.frame_globals(0)
    hist = fm.RenderHistory.create(cfg, device=dev)
    kb.reset_launches()
    out, _ = fm.render_frame(built.plan, built.batch, g, hist, mm, nm)
    torch.cuda.synchronize()
    assert kb.launches["sky_lut"] == kb.launches["sky_lut_procedural"] == 0
    assert kb.launches["ssao_taps"] == 1
    clear = clouds._vec([0.2, 0.4, 1.0], dev)[:, None, None]
    sky_px = (out.clouds != clear).any(0)
    assert float(sky_px.float().mean()) > 0.1
    assert torch.isfinite(out.clouds).all()
    a = clouds.render_clouds(g, out.gbuffer.depth, built.batch.cloud_noise,
                             128, 64, full_width=256, full_height=128)
    b = clouds.render_clouds(g, out.gbuffer.depth, built.batch.cloud_noise,
                             128, 64, full_width=256, full_height=128,
                             rows_per_chunk=7)
    assert torch.equal(a, out.clouds) and torch.equal(a, b)


def test_decode_png_on_the_card_machine(dev, tmp_path):
    """utils/png.py where the card is: the C++ unfilter builds with that
    machine's g++ and equals the numpy one on every filter type; maps of
    each colour type encode_png writes decode to their pixels, and to
    PIL's RGBA where PIL imports there."""
    from soc_real_time_renderer_tpu_torch.utils import png
    lib = png.load()
    assert lib is not None, "g++ builds csrc/png_unfilter.cpp"
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 256, (31, 1 + 4 * 53)).astype(np.uint8)
    rows[:, 0] = np.arange(31) % 5
    a = png.unfilter_native(rows.tobytes(), 31, 4 * 53, 4, lib)
    b = png.unfilter_numpy(rows.tobytes(), 31, 4 * 53, 4)
    assert a.tobytes() == b.tobytes()
    try:
        import io
        from PIL import Image
    except ImportError:
        Image = None
    for c in (1, 2, 3, 4):
        img = rng.integers(0, 256, (37, 23, c)).astype(np.uint8)
        data = png.encode_png(img, filter_type=c)
        got = png.decode_png(data)
        rgba = {1: np.concatenate([img.repeat(3, 2), np.full_like(img, 255)],
                                  2),
                2: np.concatenate([img[..., :1].repeat(3, 2), img[..., 1:]],
                                  2),
                3: np.concatenate([img, np.full_like(img[..., :1], 255)], 2),
                4: img}[c]
        assert got.tobytes() == rgba.tobytes()
        if Image is not None:
            with Image.open(io.BytesIO(data)) as im:
                assert np.asarray(im.convert("RGBA")).tobytes() \
                    == got.tobytes()


def test_preset_frame_kernel_path_matches_plain(dev, tmp_path, monkeypatch):
    """Three frames of `helmet_lifted` from a small synthetic asset tree
    (500-triangle helmet, 64^2 maps, 64^2 noise PNG) at 256x128 with a
    512^2 shadow map: all six kernels launch on every frame (K6 fed from
    Clouds/noise.png, K4 on the lifted helmet), K6p never, and the colour
    equals the plain path's within 1e-5."""
    from soc_real_time_renderer_tpu_torch.tools import synth_assets
    synth_assets.write_asset_tree(str(tmp_path), rings=10, segments=25,
                                  helmet_map=64, sponza=False)
    monkeypatch.setattr(scenes, "ASSETS", str(tmp_path))
    built = scenes.build("helmet_lifted", RenderConfig(
        width=256, height=128, shadow_resolution=512), device=dev,
        atlas_size=64)
    assert built.batch.cloud_noise is not None
    hk = hp = fm.RenderHistory.create(built.plan.config, device=dev)
    kb.reset_launches()
    for f in range(3):
        g, mm, nm = built.frame_globals(f)
        ok, hk = fm.render_frame(built.plan, built.batch, g, hk, mm, nm)
        op, hp = fm.render_frame(built.plan, built.batch, g, hp, mm, nm,
                                 impl="plain")
    torch.cuda.synchronize()
    assert kb.launches == {k: (0 if k in OFF_FRAME else 3)
                           for k in kb.launches}
    assert torch.isfinite(ok.color).all()
    assert (ok.color - op.color).abs().max().item() < 1e-5


def test_viewer_on_the_card(dev, tmp_path, monkeypatch):
    """The viewer's server on `helmet_lifted` from a small synthetic tree
    at 128x64 (512^2 shadow map) with the real make_render_fn: JPEGs
    arrive, each of the six kernels launches once in every frame (K6p,
    the noise texture being there, never), and a
    resize to 160x96 brings frames of that size with a history on the
    card."""
    import io
    import json
    import threading
    import time
    import urllib.request

    from PIL import Image

    from soc_real_time_renderer_tpu_torch.ui import server as srv
    monkeypatch.setattr(scenes, "ASSETS", kit.small_tree(tmp_path))
    built = scenes.build("helmet_lifted", RenderConfig(
        width=128, height=64, shadow_resolution=512), device=dev,
        atlas_size=64)
    per_frame = []
    real = fm.make_render_fn

    def counted(plan, impl=None):
        fn = real(plan, impl)

        def render(*a):
            before = dict(kb.launches)
            out = fn(*a)
            per_frame.append({k: kb.launches[k] - before[k] for k in before})
            return out
        return render

    monkeypatch.setattr(fm, "make_render_fn", counted)
    before = set(threading.enumerate())
    server, state, _ = srv.start_server(
        built, fm.make_render_fn(built.plan),
        fm.RenderHistory.create(built.plan.config, device=dev), port=0,
        host="127.0.0.1")
    loop = [t for t in threading.enumerate() if t not in before][0]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def size():
        with urllib.request.urlopen(base + "/frame.jpg", timeout=30) as r:
            jpg = r.read()
        return (Image.open(io.BytesIO(jpg)).size
                if jpg.startswith(b"\xff\xd8") else None)

    def wait(cond, seconds=120.0):
        deadline = time.time() + seconds
        while not cond():
            assert time.time() < deadline and loop.is_alive()
            time.sleep(0.05)

    try:
        wait(lambda: size() == (128, 64) and state.frame_index > 4)
        req = urllib.request.Request(
            base + "/resize", data=json.dumps(
                {"width": 160, "height": 96}).encode(), method="POST")
        urllib.request.urlopen(req, timeout=30).read()
        wait(lambda: size() == (160, 96))
        n = state.frame_index
        wait(lambda: state.frame_index > n + 2)
        assert state.history.previous_color.device.type == "cuda"
        assert state.history.previous_color.shape == (3, 96, 160)
    finally:
        state.stop = True
        server.shutdown()
        server.server_close()
        loop.join(timeout=120)
    assert not loop.is_alive() and len(per_frame) > 6
    assert all(d == {k: (0 if k in OFF_FRAME else 1)
                     for k in kb.launches} for d in per_frame)


# --- B views in one step (parallel/mesh.py) --------------------------------

VIEW_POSITIONS = ([-7.0, 33.8, 0.0], [-4.0, 35.0, 2.0], [-8.0, 34.5, -2.5],
                  [-2.0, 34.0, -1.0])


def _views(built, B, positions=VIEW_POSITIONS):
    """(batched globals, history, mm, nm) of B cameras at distinct
    positions."""
    from soc_real_time_renderer_tpu_torch.parallel import mesh as pmesh
    gs, mm, nm = pmesh.view_globals(built, positions[:B], 0)
    hb = pmesh.batched_history([fm.RenderHistory.create(
        built.plan.config, device=built.device) for _ in range(B)])
    return pmesh.batched_globals(gs), hb, mm, nm


@pytest.mark.parametrize("B", [3, 1])
def test_batched_kernels_match_plain(dev, B):
    """Each of K1, K4, K9, K2, K6 and K3f on the inputs of a batched frame
    of the small atrium_lifted (B views from distinct cameras, so of
    different content) against its plain version with the same view
    axis: bit-identical (tri_id equal; K9's five targets).  The inputs are recorded as chip_smoke.py's batched phase
    records them."""
    import chip_smoke
    from soc_real_time_renderer_tpu_torch.parallel import mesh as pmesh
    built = kit.build_port("atrium_lifted",
                           RenderConfig(width=256, height=128,
                                        shadow_resolution=512), dev)
    gb, hb, mm, nm = _views(built, B)
    step = pmesh.make_batched_render_fn(built.plan, impl="plain")
    seen = chip_smoke.recorded_inputs(
        lambda: step(built.batch, gb, hb, mm, nm))
    assert sorted(seen) == sorted(k for k in kb.launches
                                  if k not in OFF_FRAME)
    for k, (fn, a, kw) in seen.items():
        got, want = fn(*a, impl="cuda", **kw), fn(*a, impl="plain", **kw)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        lead = B
        for x, y in zip(got, want):
            assert x.shape[0] == lead, (k, x.shape)
            assert torch.equal(x, y), k
    # the views differ: view 0's image is not view 1's
    if B > 1:
        depth = seen["resolve"][0](*seen["resolve"][1], impl="cuda",
                                   **seen["resolve"][2])[0]
        assert not torch.equal(depth[0], depth[1])


def test_batched_step_launches_each_kernel_once(dev):
    """One batched step of three views launches each of the six kernels
    once (K6p never: the scene has the noise texture), and view i equals
    render_frame of view i."""
    from soc_real_time_renderer_tpu_torch.config import select_view
    from soc_real_time_renderer_tpu_torch.parallel import mesh as pmesh
    built = kit.build_port("atrium_lifted",
                           RenderConfig(width=256, height=128,
                                        shadow_resolution=512), dev)
    gb, hb, mm, nm = _views(built, 3)
    step = pmesh.make_batched_render_fn(built.plan)
    kb.reset_launches()
    colors, hb2 = step(built.batch, gb, hb, mm, nm)
    torch.cuda.synchronize()
    assert kb.launches == {k: (0 if k in OFF_FRAME else 1)
                           for k in kb.launches}
    for i in range(3):
        out, h = fm.render_frame(
            built.plan, built.batch, select_view(gb, i),
            fm.RenderHistory.create(built.plan.config, device=dev), mm, nm)
        assert (out.color - colors[i]).abs().max().item() <= 1e-6
        assert (h.exposure - hb2.exposure[i]).abs().item() <= 1e-6


TERRAIN_POSITIONS = ([20.0, 12.0, 20.0], [16.0, 10.0, 25.0],
                     [18.0, 8.0, 22.0], [24.0, 10.0, 18.0])


def _batched_pass_frame(dev, name, B):
    """(views' globals, batched globals, outputs) of a batched frame of B
    views of the small `name` at 256x128 with its passes on."""
    from soc_real_time_renderer_tpu_torch.parallel import mesh as pmesh
    switches = {"atrium_passes": dict(enable_ssr=True, composite_ssr=True,
                                      enable_depth_of_field=True,
                                      enable_volumetric_light=True),
                "terrain_perpixel": dict(cloud_impl="perpixel")}[name]
    cfg = RenderConfig(width=256, height=128, shadow_resolution=512,
                       **switches)
    built = kit.build_port(name, cfg, dev)
    positions = (VIEW_POSITIONS if name == "atrium_passes"
                 else TERRAIN_POSITIONS)[:B]
    gs, mm, nm = pmesh.view_globals(built, positions, 0)
    gb = pmesh.batched_globals(gs)
    hb = pmesh.batched_history([fm.RenderHistory.create(cfg, device=dev)
                                for _ in range(B)])
    plan = dataclasses.replace(built.plan, ssr_cap=256 * 128)
    out, _ = fm.render_frame(plan, built.batch, gb, hb, mm, nm)
    return built, gs, gb, out


def _equal_views(batched, singles):
    """Each view of the batched outputs equals its single-view call's, bit
    for bit (outputs a tensor or a tuple of tensors)."""
    batched = batched if isinstance(batched, tuple) else (batched,)
    for i, one in enumerate(singles):
        one = one if isinstance(one, tuple) else (one,)
        for a, b in zip(batched, one):
            assert torch.equal(a[i], b), i


def test_batched_passes_equal_single_views(dev):
    """SSR (dense; compacted with one view over its cap), depth of field
    and the volumetric term over each view's shadow map on B = 4 views
    of the small atrium_passes, and the per-pixel cloud march on 4 views
    of the small terrain_perpixel (one chunk of rows and chunks of 7
    straddling views): each one call for the batch, each view equal to
    its single-view call bit for bit."""
    from soc_real_time_renderer_tpu_torch.ops import composition, dof
    B = 4
    built, gs, gb, out = _batched_pass_frame(dev, "atrium_passes", B)
    gbuf = out.gbuffer
    sv = [(gbuf.depth[i], gbuf.albedo[i], gbuf.normal[i],
           gbuf.metallic_roughness[i]) for i in range(B)]
    n = [int(mr[1].ge(ssr.METALLIC_MIN).sum()) for *_, mr in sv]
    assert min(n) > 0.01 * 256 * 128 and max(n) > min(n), n
    for cap in (0, (min(n) + max(n)) // 2):
        got = ssr.ssr(gbuf.depth, gbuf.albedo, gbuf.normal,
                      gbuf.metallic_roughness, gb, compact_cap=cap)
        _equal_views(got, [ssr.ssr(*a, gs[i], compact_cap=cap)
                           for i, a in enumerate(sv)])
        if cap:
            assert got[1].tolist() == [ssr.OVERFLOW_SSR_CAP if k > cap
                                       else 0 for k in n]
    _equal_views(dof.depth_of_field(out.hdr, gbuf.depth, gb),
                 [dof.depth_of_field(out.hdr[i], gbuf.depth[i], gs[i])
                  for i in range(B)])
    assert out.shadow_map.shape == (B, 512, 512)
    args = (gbuf.depth, gbuf.albedo, gbuf.emissive, gbuf.normal,
            torch.ones_like(gbuf.depth), out.shadow_map, None)
    kw = dict(enable_volumetric=True, max_point_lights=0, max_spot_lights=0)
    _equal_views(composition.compose(gb, *args, **kw),
                 [composition.compose(gs[i], *(None if a is None else a[i]
                                               for a in args), **kw)
                  for i in range(B)])

    built, gs, gb, out = _batched_pass_frame(dev, "terrain_perpixel", B)
    noise = built.batch.cloud_noise
    for rows in (64, 7):
        kw = dict(full_width=256, full_height=128, rows_per_chunk=rows)
        got = clouds.render_clouds(gb, out.gbuffer.depth, noise, 128, 64,
                                   **kw)
        _equal_views(got, [clouds.render_clouds(
            gs[i], out.gbuffer.depth[i], noise, 128, 64, **kw)
            for i in range(B)])
        assert torch.equal(got, out.clouds)


def test_ssr_launches_do_not_grow_with_the_views(dev):
    """The SSR pass of 4 views issues at most 1.25 times the CUDA
    kernels of one view's (counted with torch.profiler): one call for
    the batch, not one per view.  Through K8 both issue the same few
    kernels (the counts' zeroing and K8); the plain version over a
    thousand."""
    import chip_smoke
    _, gs, gb, out = _batched_pass_frame(dev, "atrium_passes", 4)
    gbuf = out.gbuffer
    cap = 256 * 128

    def one(impl):
        ssr.ssr(gbuf.depth[0], gbuf.albedo[0], gbuf.normal[0],
                gbuf.metallic_roughness[0], gs[0], compact_cap=cap,
                impl=impl)

    def four(impl):
        ssr.ssr(gbuf.depth, gbuf.albedo, gbuf.normal,
                gbuf.metallic_roughness, gb, compact_cap=cap, impl=impl)

    for impl in ("plain", None):
        one(impl)
        four(impl)
        k1 = chip_smoke.cuda_kernels(lambda: one(impl))
        k4 = chip_smoke.cuda_kernels(lambda: four(impl))
        if impl == "plain":
            assert 1000 < k1 and k4 <= 1.25 * k1, (k1, k4)
        else:
            assert k1 == k4 <= 3, (k1, k4)


@pytest.mark.parametrize("cap", ["dense", "over", "half", "screen"])
def test_ssr_kernel_matches_plain(dev, cap):
    """K8 against ops/ssr.ssr's plain version on the G-buffer of the
    reduced atrium_passes at 256x128, bit for bit in the image, the
    overflow and the count: the dense march (cap 0), a cap of n + 100
    and of n // 2 over the view's n reflective pixels (bit 16, the same
    count), and the screen's cap (no prefix sum); on one view, and on a
    two-view step, whose every view equals its single-view call.  One
    launch a call."""
    _, gs, gb, out = _batched_pass_frame(dev, "atrium_passes", 2)
    gbuf = out.gbuffer
    targets = (gbuf.depth, gbuf.albedo, gbuf.normal,
               gbuf.metallic_roughness)
    n = [int(mr[1].ge(ssr.METALLIC_MIN).sum())
         for mr in gbuf.metallic_roughness]
    assert min(n) > 0.01 * 256 * 128 and n[0] != n[1], n

    def capped(k):
        return {"dense": 0, "over": k + 100, "half": k // 2,
                "screen": 256 * 128}[cap]

    def both(args, g, c):
        n0 = kb.launches["ssr_march"]
        got = ssr.ssr(*args, g, compact_cap=c)
        assert kb.launches["ssr_march"] == n0 + 1
        want = ssr.ssr(*args, g, compact_cap=c, impl="plain")
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert torch.equal(a, b)
        return got

    singles = [both([t[i] for t in targets], gs[i], capped(n[i]))
               for i in range(2)]
    for i, (_, overflow, active) in enumerate(singles):
        want = -1 if cap == "dense" else n[i]
        assert int(active) == want
        assert int(overflow) == (ssr.OVERFLOW_SSR_CAP if cap == "half"
                                 else 0)
    step = both(targets, gb, capped(max(n)))
    _equal_views(step, [ssr.ssr(*[t[i] for t in targets], gs[i],
                                compact_cap=capped(max(n)))
                        for i in range(2)])


# --- the row split of one frame (parallel/halo.py, parallel/mesh.py) -------

BANDS = ((0, 1), (1, 2), (3, 1), (0, 4), (2, 2))     # (bin row0, bin rows)


@pytest.mark.parametrize("depth_only", [False, True])
def test_band_resolve_kernels_match_plain(dev, depth_only):
    """K1 (a 256x128 main grid, 4 bin rows of 32) and K4 (a 512^2 shadow
    grid, 4 bin rows of 128) resolving a band of bin rows of the whole
    starts table: bit-identical to the plain version's band and to the
    whole resolve's rows, the first and the last band included; a band
    that starts above the grid (negative row0) or runs past it raises on
    both paths before anything launches."""
    if depth_only:
        S = 512
        clip = _soup(400, S, S, S).to(dev)
        setup = raster2.triangle_setup_planar(clip, S, S, "back")
        grid, fn = _shadow_grid(S), raster2.resolve_depth
    else:
        clip = _soup(300, 3, 256, 128).to(dev)
        setup = raster2.triangle_setup_planar(clip, 256, 128, "front")
        grid = raster2.BinGrid(width=256, height=128, bin_w=64, bin_h=32,
                               group=2)
        fn = raster2.resolve
    starts, recs, _, rgrid = raster2.gather_records(setup, grid)
    assert rgrid.by == 4
    whole = fn(starts, recs, rgrid, impl="plain")
    whole = whole if isinstance(whole, tuple) else (whole,)
    key = "resolve_depth" if depth_only else "resolve"
    for row0, n in BANDS:
        n0 = kb.launches[key]
        k = fn(starts, recs, rgrid, row0=row0, band_by=n)
        assert kb.launches[key] == n0 + 1
        p = fn(starts, recs, rgrid, impl="plain", row0=row0, band_by=n)
        torch.cuda.synchronize()
        k = k if isinstance(k, tuple) else (k,)
        p = p if isinstance(p, tuple) else (p,)
        rows = slice(row0 * rgrid.bh, (row0 + n) * rgrid.bh)
        for a, b, w in zip(k, p, whole):
            assert a.shape[-2] == n * rgrid.bh
            assert torch.equal(a, b) and torch.equal(a, w[rows])
    assert (whole[0] < 1.0).any()
    for impl in (None, "plain"):
        n0 = kb.launches[key]
        for row0, n in ((-1, 1), (3, 2)):
            with pytest.raises(ValueError):
                fn(starts, recs, rgrid, impl=impl, row0=row0, band_by=n)
        assert kb.launches[key] == n0


@pytest.mark.parametrize("views", [0, 2])
def test_band_taa_kernel_matches_plain(dev, views):
    """K3 fetching for a band of screen rows from the whole history (row0
    and full_h): bit-identical to the plain version's band and to the
    whole fetch's rows, with velocities that throw taps past the band
    and off the screen, one row bands and the edge bands included, and
    with a view axis; a negative row0 or a band past the screen raises
    on both paths."""
    g = torch.Generator(device="cpu").manual_seed(5 + views)
    V = (views,) if views else ()
    H, W = 72, 136
    hist = (torch.rand(*V, 5, H, W, generator=g) * 3).to(torch.bfloat16)
    vel = (torch.rand(*V, 2, H, W, generator=g) - 0.5) * 0.6
    hist, vel = hist.to(dev), vel.to(dev)
    whole = taa.reproject_history(hist, vel, impl="plain")
    for a, b in ((0, 18), (18, 36), (54, 72), (35, 36), (0, 72)):
        n0 = kb.launches["taa_reproject"]
        k = taa.reproject_history(hist, vel[..., a:b, :], row0=a)
        assert kb.launches["taa_reproject"] == n0 + 1
        p = taa.reproject_history(hist, vel[..., a:b, :], impl="plain",
                                  row0=a)
        torch.cuda.synchronize()
        assert torch.equal(k, p) and torch.equal(k, whole[..., a:b, :])
    for impl in (None, "plain"):
        for row0 in (-1, 68):                 # 8 rows from row0
            with pytest.raises(ValueError):
                taa.reproject_history(hist, vel[..., :8, :], impl=impl,
                                      row0=row0)


def test_sharded_frame_on_one_card(dev):
    """Two frames of the small atrium_lifted (all six kernels) split in
    four row bands over a ["cuda:0"] * 4 mesh: K1, K4, K9, K2 and K3f
    launch once per band, K6 once (one distinct device); colour, history
    and exposure within 1e-6 of the unsplit frame.  Then the meshed
    batched step over a (dp = 2, sp = 2) mesh of the card: each view
    within 1e-6 of the unmeshed step."""
    from soc_real_time_renderer_tpu_torch.parallel import halo
    from soc_real_time_renderer_tpu_torch.parallel import mesh as pmesh
    built = kit.build_port("atrium_lifted",
                           RenderConfig(width=256, height=128,
                                        shadow_resolution=512), dev)
    mesh = pmesh.make_mesh(4, dp=1, devices=["cuda:0"] * 4)
    splan = dataclasses.replace(built.plan, shard_mesh=mesh,
                                shard_axis="sp")
    hs = hu = fm.RenderHistory.create(built.plan.config, device=dev)
    for f in range(2):
        g, mm, nm = built.frame_globals(f)
        kb.reset_launches()
        out, hs = fm.render_frame(splan, built.batch, g, hs, mm, nm)
        torch.cuda.synchronize()
        assert kb.launches == {"resolve": 4, "resolve_depth": 4,
                               "texsample": 0, "ssao_taps": 4, "sky_lut": 1,
                               "sky_lut_procedural": 0,
                               "taa_reproject": 0,
                               "taa_resolve": 4, "local_lights": 0,
                               "ssr_march": 0, "gbuffer_resolve": 4}, \
            kb.launches
        want, hu = fm.render_frame(built.plan, built.batch, g, hu, mm, nm)
        assert [b.shape for b in out.color] == [(3, 32, 256)] * 4
        assert all(b.device == dev for b in out.color)
        for a, b in ((want.color, out.color),
                     (hu.previous_color, hs.previous_color)):
            assert (a.float() - halo.assemble(b, dev).float()).abs().max() \
                .item() <= 1e-6
        assert (hu.exposure - hs.exposure).abs().item() <= 1e-6
    gb, hb, mm, nm = _views(built, 2)
    colors, _ = pmesh.make_batched_render_fn(built.plan)(
        built.batch, gb, hb, mm, nm)
    meshed = pmesh.make_batched_render_fn(
        built.plan, mesh=pmesh.make_mesh(4, dp=2, devices=["cuda:0"] * 4))
    got, _ = meshed(built.batch, gb, hb, mm, nm)
    assert (pmesh.assemble_views(got, dev) - colors).abs().max().item() \
        <= 1e-6


@pytest.mark.parametrize("texture_filter", ["bilinear", "none"])
def test_bench_loop_launches_once_and_never_waits(dev, texture_filter):
    """tools/bench.py's timed loop on the card (the small terrain at
    256x128, 3 staged frames): each kernel of the plan's path once a
    frame and no other (K9 in both filter modes: "none", bench_toggle's
    tex_none, is a mode of it), and no call inside the loop waits for the
    card (the exposure histogram's bincount once did, twice a frame)."""
    from soc_real_time_renderer_tpu_torch.tools import bench
    hm = terrain.procedural_heightmap(64)
    model = terrain.build_terrain_model(hm, terrain.default_albedo(hm),
                                        tess_level=1)
    scene = Scene("terrain")
    e = scene.create_entity("terrain")
    e.add_component(TransformComponent())
    e.add_component(MeshComponent()).model = model
    built = scenes._finish(scene, [model], RenderConfig(width=256, height=128),
                           [20.0, 12.0, 20.0], [50, 0, 50], device=dev,
                           atlas_size=64)
    plan = dataclasses.replace(built.plan, texture_filter=texture_filter)
    staged = bench.stage(built, plan, 3)
    bench.run(built, plan, staged)
    t = bench.run(built, plan, staged)
    want = ["resolve", "gbuffer_resolve", "ssao_taps", "taa_resolve",
            "sky_lut_procedural"]
    assert t.path == want
    assert t.launches == {k: (3 if k in want else 0) for k in t.launches}
    assert t.syncs == {}
    assert len(t.frame_ms) == 3 and t.total_ms > 0 and t.peak_mib > 0
    assert torch.isfinite(t.outputs.color).all()


# --- K7, the local lights (ops/composition.py, kernels/csrc/lights.cu) ------

LIT_VIEWS = ([-7.0, 1.8, 0.0], [-4.0, 2.0, 2.0], [5.0, 2.5, -2.0],
             [0.5, 3.0, 4.0])


def _spy_lights(monkeypatch):
    """Every call of composition._local_lights, recorded: [(args, kwargs
    without impl)]."""
    from soc_real_time_renderer_tpu_torch.ops import composition
    real, calls = composition._local_lights, []

    def spy(*a, **kw):
        calls.append((a, {n: v for n, v in kw.items() if n != "impl"}))
        return real(*a, **kw)
    monkeypatch.setattr(composition, "_local_lights", spy)
    return real, calls


@pytest.fixture(scope="module")
def lit_atrium(tmp_path_factory):
    """The full_lit preset at 1920x1088 from a small synthetic asset tree
    (its own atrium and terrain at their real sizes) on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from soc_real_time_renderer_tpu_torch.tools import synth_assets
    root = str(tmp_path_factory.mktemp("assets"))
    synth_assets.write_asset_tree(root, rings=10, segments=25,
                                  helmet_map=64, sponza_map=64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scenes, "ASSETS", root)
        return scenes.build("full_lit", RenderConfig(width=1920,
                                                     height=1088),
                            device=torch.device("cuda:0"))


def _lights_both(real, a, kw):
    """K7 and the plain loop on one call's inputs: K7 launched once,
    both (3, *V, P)."""
    n0 = kb.launches["local_lights"]
    got = real(*a, impl="cuda", **kw)
    assert kb.launches["local_lights"] == n0 + 1
    want = real(*a, impl="plain", **kw)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("case", ["frame", "band", "views4"])
def test_local_lights_kernel_matches_plain(lit_atrium, monkeypatch, case):
    """K7 against its plain loop on the G-buffer planes a frame of the
    lit atrium hands composition (128 point and 128 spot lights live,
    1920x1088): bit for bit.  "band": rows 272-543 as a strided slice of
    the frame's planes (a row band's pixels); "views4": the planes of one
    batched step of four views, each with its own camera and lights."""
    from soc_real_time_renderer_tpu_torch.parallel import mesh as pmesh
    built = lit_atrium
    assert (built.plan.config.max_point_lights,
            built.plan.config.max_spot_lights) == (128, 128)
    real, calls = _spy_lights(monkeypatch)
    if case == "views4":
        gb, hb, mm, nm = _views(built, 4, LIT_VIEWS)
        pmesh.make_batched_render_fn(built.plan)(built.batch, gb, hb, mm, nm)
    else:
        g, mm, nm = built.frame_globals(3)
        fm.render_frame(built.plan, built.batch, g, fm.RenderHistory.create(
            built.plan.config, device=built.device), mm, nm)
    (a, kw), = calls
    g, alb, nrm, pos, n_point, n_spot = a
    assert (n_point, n_spot) == (128, 128)
    P = 1920 * 1088
    assert alb.shape == ((3, 4, P) if case == "views4" else (3, P))
    if case == "band":
        alb, nrm, pos = (x[:, 272 * 1920:544 * 1920] for x in (alb, nrm, pos))
        assert alb.stride() == (P, 1)
    got, want = _lights_both(real, (g, alb, nrm, pos, n_point, n_spot), kw)
    assert got.shape == want.shape == alb.shape
    assert torch.isfinite(want).all() and want.abs().max().item() > 0
    assert torch.equal(got, want)
    if case == "views4":
        assert not torch.equal(got[:, 0], got[:, 1])


def test_compose_launches_the_local_lights_once_in_its_graph(lit_atrium,
                                                             monkeypatch):
    """Four frames of the lit atrium through make_render_fn: K7 launches
    once a frame.  Frame 0 runs eagerly, frame 1 captures each pass and
    replays it, frames 2-3 replay shade.compose's graph, so the wrapper's
    Python no longer runs and its launch and its counters come from the
    replay; each frame equals render_frame's at max abs 0."""
    from soc_real_time_renderer_tpu_torch.utils import trace
    built = lit_atrium
    _, calls = _spy_lights(monkeypatch)
    render = fm.make_render_fn(built.plan)
    hr = he = fm.RenderHistory.create(built.plan.config, device=built.device)
    P = 1920 * 1088
    built.frame_globals(9)    # every frame below has a camera_prev of its own
    for k in range(4):
        g, mm, nm = built.frame_globals(10 + k)
        n_calls, n0 = len(calls), kb.launches["local_lights"]
        c0 = dict(trace.counters)
        replays = trace.counters["graph_replays"]
        out_r, hr = render(built.batch, g, hr, mm, nm)
        torch.cuda.synchronize()
        assert kb.launches["local_lights"] == n0 + 1, k
        assert trace.counters["light_pairs"] - c0.get("light_pairs", 0) \
            == 256 * P
        assert trace.counters["spot_light_pairs"] \
            - c0.get("spot_light_pairs", 0) == 128 * P
        assert trace.counters["light_pixels"] - c0.get("light_pixels", 0) \
            == P
        replayed = trace.counters["graph_replays"] > replays
        assert replayed == (k >= 1), k
        assert len(calls) == n_calls + (1 if k <= 1 else 0), k
        out_e, he = fm.render_frame(built.plan, built.batch, g, he, mm, nm)
        assert torch.equal(out_r.color, out_e.color), k
        assert torch.equal(hr.previous_color, he.previous_color), k


# --- the frame's globals in one packed copy (config.upload) ----------------

UPLOAD_CFG = RenderConfig(width=256, height=128, shadow_resolution=1024)


def _leaf_by_leaf(obj, device):
    """config.upload as tree_to's blocking copies, one a leaf."""
    from soc_real_time_renderer_tpu_torch.config import tree_to
    return tuple(tree_to(o, device) for o in obj)


def _counted(fn):
    """(fn(), the trace counters it added)."""
    from soc_real_time_renderer_tpu_torch.utils import trace
    c0 = dict(trace.counters)
    out = fn()
    return out, {k: v - c0.get(k, 0) for k, v in trace.counters.items()
                 if v != c0.get(k, 0)}


@pytest.mark.parametrize("name, site", [
    ("full_nohelmet", "check_sun_proof"),
    ("atrium_lifted", "check_shadow_crop")])
def test_replayed_frames_on_packed_globals_equal_leaf_by_leaf(
        dev, monkeypatch, name, site):
    """Six frames through make_render_fn on frame_globals' packed globals
    and, beside them, through a render function of their own on the same
    frames' globals copied leaf by leaf: every target and the history
    bit for bit.  Once the frames replay, the packed frame's proof check
    reads the host's copy and nothing from the card."""
    from soc_real_time_renderer_tpu_torch.graph import replay
    built = kit.build_port(name, UPLOAD_CFG, dev)
    packed, leafwise = (fm.make_render_fn(built.plan) for _ in range(2))
    hp = hl = fm.RenderHistory.create(built.plan.config, device=dev)
    for k in range(6):
        with monkeypatch.context() as m:
            m.setattr(scenes, "upload", _leaf_by_leaf)
            gl, mml, nml = built.frame_globals(k, peek=True)
        g, mm, nm = built.frame_globals(k)
        (out_p, hp), c = _counted(
            lambda: packed(built.batch, g, hp, mm, nm))
        out_l, hl = leafwise(built.batch, gl, hl, mml, nml)
        torch.cuda.synchronize()
        got, want = replay._leaves((out_p, hp)), replay._leaves((out_l, hl))
        assert len(got) == len(want) > 10
        for a, b in zip(got, want):
            assert torch.equal(a, b), k
        assert c.get("d2h_mirrored." + site) == 1, (k, c)
        assert not any(n.startswith("d2h_reads") for n in c), (k, c)
        assert (c.get("graph_replays", 0) > 0) == (k >= 2), (k, c)


@pytest.mark.parametrize("name", ["full_nohelmet", "atrium_lifted"])
def test_frames_never_wait_for_the_card(dev, name):
    """Frames 3-12 of make_render_fn, from frame_globals through the
    replayed render, under torch.cuda.set_sync_debug_mode("error"): no
    call waits for the card (the globals cross in one non-blocking copy
    from pinned memory, the proof checks read the host's copy)."""
    built = kit.build_port(name, UPLOAD_CFG, dev)
    render = fm.make_render_fn(built.plan)
    h = fm.RenderHistory.create(built.plan.config, device=dev)
    trace.reset()
    try:
        for k in range(13):
            if k == 3:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            g, mm, nm = built.frame_globals(k)
            out, h = render(built.batch, g, h, mm, nm)
            trace.last_frame()          # the device clock reads, unwaiting
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.isfinite(out.color).all()
    # the clock ran all along: the last frame, replayed, read whole
    f = trace.last_frame()
    assert {"raster.main", "shade.taa", "replay.copy"} <= set(f["passes"])
    assert 0 < sum(f["passes"].values()) <= f["ms"] + 1e-3


def test_batched_step_never_waits_for_the_card(dev):
    """Steps 3-7 of four views (parallel/mesh: view_globals, each view's
    previous camera its own, batched_globals, make_batched_render_fn)
    under set_sync_debug_mode("error"): the four uploads and the stacked
    sun's proof check do not wait for the card."""
    from soc_real_time_renderer_tpu_torch.parallel import mesh as pmesh
    built = kit.build_port("full_nohelmet", UPLOAD_CFG, dev)
    step = pmesh.make_batched_render_fn(built.plan)
    hb = pmesh.batched_history([fm.RenderHistory.create(
        built.plan.config, device=dev) for _ in range(4)])
    cams = None
    trace.reset()
    try:
        for k in range(8):
            if k == 3:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            gs, mm, nm = pmesh.view_globals(built, VIEW_POSITIONS, k, cams)
            if cams is None:
                gs = [dataclasses.replace(g, camera_prev=g.camera)
                      for g in gs]
            cams = [g.camera for g in gs]
            colors, hb = step(built.batch, pmesh.batched_globals(gs), hb,
                              mm, nm)
            trace.last_frame()          # the device clock reads, unwaiting
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert colors.shape[0] == 4 and torch.isfinite(colors).all()
    # the clock ran on the eager step: one frame a step, its passes
    f = trace.last_frame()
    assert {"raster.main", "shade.taa"} <= set(f["passes"])
    assert "replay.copy" not in f["passes"]
    assert 0 < sum(f["passes"].values()) <= f["ms"] + 1e-3


def test_the_capture_call_records_no_event(dev, monkeypatch):
    """make_render_fn's first calls: the eager warm-ups and each replay
    bracket their passes on the device clock; the call that captures the
    graphs records no event."""
    import inspect
    built = kit.build_port("full_nohelmet", UPLOAD_CFG, dev)
    render = fm.make_render_fn(built.plan)
    graphs = inspect.getclosurevars(render).nonlocals["graphs"]
    h = fm.RenderHistory.create(built.plan.config, device=dev)
    made = []
    real = trace._event
    monkeypatch.setattr(trace, "_event",
                        lambda stream: (made.append(stream), real(stream))[1])
    calls = {}
    for k in range(5):
        g, mm, nm = built.frame_globals(k)
        made.clear()
        kind = "replay" if graphs.stages else "warm"
        out, h = render(built.batch, g, h, mm, nm)
        if kind == "warm" and graphs.stages:
            kind = "capture"
        torch.cuda.synchronize()
        calls[kind] = (len(made), trace.last_frame())
    (warm, fw), (capture, _), (replayed, fr) = \
        calls["warm"], calls["capture"], calls["replay"]
    assert capture == 0
    assert warm >= 2 + 2 * len(fw["passes"]) and "shade.taa" in fw["passes"]
    assert replayed >= 2 + 2 * len(fr["passes"])
    assert "replay.copy" in fr["passes"]
    assert [n for n in fr["passes"] if n.startswith(("raster.", "shade."))] \
        == [n for n in fw["passes"] if n.startswith(("raster.", "shade."))]


@pytest.fixture(scope="module")
def full_screen():
    """full_nohelmet (the kit's small atrium and terrain) at 1920x1088 on
    the card, through make_render_fn, past its warm-up and capture:
    (built, render, [history, next frame index])."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda:0")
    built = kit.build_port("full_nohelmet",
                           RenderConfig(width=1920, height=1088), dev)
    render = fm.make_render_fn(built.plan)
    h = fm.RenderHistory.create(built.plan.config, device=dev)
    for k in range(3):
        g, mm, nm = built.frame_globals(k)
        out, h = render(built.batch, g, h, mm, nm)
    torch.cuda.synchronize()
    return built, render, [h, 3]


def _frames(state, n):
    built, render, carry = state
    for _ in range(n):
        g, mm, nm = built.frame_globals(carry[1])
        _, carry[0] = render(built.batch, g, carry[0], mm, nm)
        carry[1] += 1


def _behind_a_sleep(state, eager=False):
    """One frame, its globals uploaded, then enqueued behind a ~135 ms
    sleeping kernel, so that the card runs it back to back: replayed, or
    eager (render_frame called directly); the device ms between two
    events around the render call (the harness's end-of-frame marks),
    and the clock's reading of the frame."""
    built, render, carry = state
    g, mm, nm = built.frame_globals(carry[1])
    torch.cuda._sleep(1 << 28)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    if eager:
        _, carry[0] = fm.render_frame(built.plan, built.batch, g, carry[0],
                                      mm, nm)
    else:
        _, carry[0] = render(built.batch, g, carry[0], mm, nm)
    carry[1] += 1
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b), trace.last_frame()


@pytest.mark.parametrize("eager", [True, False], ids=["eager", "replayed"])
def test_the_device_clock_times_the_whole_frame(full_screen, eager):
    """Frames at 1920x1088 behind a sleep: the passes and copies fill the
    clock's frame (under 2% of it idle).  An eager frame's clock equals
    the events' interval around the call within 2%; a replayed frame's
    interval also holds the copy of its inputs into the graphs' static
    tensors, which lies before frame.render: under 5% more."""
    trace.reset()
    for _ in range(4):
        ms, f = _behind_a_sleep(full_screen, eager)
        assert abs(f["idle_ms"]) < 0.02 * f["ms"], (ms, f)
        assert sum(f["passes"].values()) + f["idle_ms"] == pytest.approx(
            f["ms"])
        if eager:
            assert f["ms"] == pytest.approx(ms, rel=0.02), (ms, f)
        else:
            assert 0.95 * ms < f["ms"] < ms * 1.001, (ms, f)


def test_the_device_clock_agrees_with_the_profiler(full_screen):
    """Three replayed frames at 1920x1088 read by the clock, each behind
    a sleep, then three more under torch.profiler behind one: for each
    pass of 0.3 device ms or more, the clock's device ms equal the
    profiler's (its kernels linked to the pass's span,
    benchmark/passes.program_records) within 10% plus 2 us a launch:
    an interval holds the gaps between kernels that a sum of kernel
    times leaves out; the clock records nothing under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    from benchmark import passes
    trace.reset()
    clock: dict = {}
    for _ in range(3):
        _, f = _behind_a_sleep(full_screen)
        for n, ms in f["passes"].items():
            clock[n] = clock.get(n, 0.0) + ms
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1 << 28)
        _frames(full_screen, 3)
        torch.cuda.synchronize()
    assert trace.last_frame() is f
    events = prof.events()
    window = (min(e.time_range.start for e in events),
              max(e.time_range.end for e in events))
    prog = passes.program_records(events, window)["program"]
    big = [n for n, ms in clock.items() if n.startswith(("raster.", "shade."))
           and ms / 3 >= 0.3]
    assert len(big) >= 4, clock
    for n in big:
        p = prog[n]
        assert p["calls"] == 3
        kernels_ms = p["device_s"] * 1e3
        assert abs(clock[n] - kernels_ms) \
            <= 0.10 * kernels_ms + 0.002 * p["launches"], (n, clock[n], p)


def test_uploads_behind_a_busy_card_keep_their_values(dev, monkeypatch):
    """Sixteen frames' globals, each uploaded behind a ~10 ms kernel, so
    that every copy still waits on the stream when the next frame's
    pinned buffer is filled: each frame's leaves equal those of the same
    frame copied leaf by leaf (no staging buffer is rewritten before its
    copy has run)."""
    from soc_real_time_renderer_tpu_torch.graph import replay
    built = kit.build_port("full_nohelmet", UPLOAD_CFG, dev)
    want = []
    with monkeypatch.context() as m:
        m.setattr(scenes, "upload", _leaf_by_leaf)
        for k in range(16):
            want.append([t.cpu() for t in
                         replay._leaves(built.frame_globals(k))])
    del built._prev_cam
    got = []
    for k in range(16):
        torch.cuda._sleep(20_000_000)
        got.append(built.frame_globals(k))
    torch.cuda.synchronize()
    for k, (w, g) in enumerate(zip(want, got)):
        leaves = replay._leaves(g)
        assert len(leaves) == len(w)
        for a, b in zip(w, leaves):
            assert torch.equal(a, b.cpu()), k
