"""The passes that are off by default, port against the JAX package on
the CPU, op by op: the comparison-sampled shadow tap and the volumetric
light over a rendered map, SSR (dense, compacted, over its cap), depth
of field with its mip chain and the per-pixel cloud march.  The frames
with those switches on are in tests/test_torch_passes_frames.py and
tests/test_torch_switches.py.  Inputs come from numpy seeds; every
bound is stated with its reason.  XLA's CPU jit contracts ``a*b + c``
into FMA and the port does not, so bounds are ulp-level, not bitwise
(ROADMAP fault C7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_scene_kit as kit
from soc_real_time_renderer_tpu import config as jcfg
from soc_real_time_renderer_tpu.camera import Camera3D, camera_matrices
from soc_real_time_renderer_tpu.ops import clouds as jclouds
from soc_real_time_renderer_tpu.ops import composition as jcomp
from soc_real_time_renderer_tpu.ops import dof as jdof
from soc_real_time_renderer_tpu.ops import sampling as jsampling
from soc_real_time_renderer_tpu.ops import ssr as jssr
from soc_real_time_renderer_tpu_torch import convert
from soc_real_time_renderer_tpu_torch.config import RenderConfig
from soc_real_time_renderer_tpu_torch.graph import frame as pframe
from soc_real_time_renderer_tpu_torch.ops import clouds as pclouds
from soc_real_time_renderer_tpu_torch.ops import composition as pcomp
from soc_real_time_renderer_tpu_torch.ops import dof as pdof
from soc_real_time_renderer_tpu_torch.ops import gbuffer as pgbuf
from soc_real_time_renderer_tpu_torch.ops import sampling as psampling
from soc_real_time_renderer_tpu_torch.ops import ssr as pssr


def _globals(W, H, position=(0, 0, 1.0), **kw):
    """(JAX globals, port globals) of a default camera at `position`."""
    cam = Camera3D()
    cam.resize(W, H)
    cm = camera_matrices(cam, list(position), 1, W, H)
    jg = jcfg.ShaderGlobals.create(camera=cm, camera_prev=cm,
                                   frame_counter=np.int32(1), **kw)
    return jg, convert.globals_from_numpy(jg)


# ---------------------------------------------------------------- A15

@pytest.mark.parametrize("span", ["inside", "border"])
def test_sample_shadow_cmp_matches_jax(span):
    """2x2 bilinear of LESS comparisons, border 1.0.  The comparisons
    read the same texels of the same map, so they cannot flip; the
    blend weights differ by an ulp of the texel coordinate (XLA
    contracts uv * S - 0.5): max abs <= 1e-5.  "border": uv in
    [-0.3, 1.3], so a third of the taps read border texels."""
    rng = np.random.default_rng(4)
    S = 64
    shadow = rng.random((S, S), dtype=np.float32)
    lo, hi = (0.02, 0.98) if span == "inside" else (-0.3, 1.3)
    uv = rng.uniform(lo, hi, (2, 5000)).astype(np.float32)
    ref = rng.random(5000, dtype=np.float32)
    want = np.asarray(jax.jit(jsampling.sample_shadow_cmp)(shadow, uv, ref))
    got = psampling.sample_shadow_cmp(
        torch.from_numpy(shadow), torch.from_numpy(uv),
        torch.from_numpy(ref)).numpy()
    assert np.abs(got - want).max() <= 1e-5
    assert 0.2 < got.mean() < 0.9
    if span == "border":
        out = (uv < 0).any(0) | (uv > 1).any(0)
        assert out.mean() > 0.3
        # a tap wholly outside the map compares against the border
        far = (uv < -2.0 / S).any(0) | (uv > 1 + 2.0 / S).any(0)
        assert np.array_equal(got[far], (ref[far] < 1.0).astype(np.float32))


def test_sample_shadow_cmp_far_outside_and_nan():
    """Coordinates far outside the map (beyond the int32 range after
    scaling) read the border on all four texels; NaN coordinates give
    NaN, as in the JAX package."""
    shadow = torch.zeros(8, 8)
    uv = torch.tensor([[1e12, -1e12, float("nan")],
                       [0.5, 0.5, 0.5]])
    ref = torch.tensor([0.5, 0.5, 0.5])
    got = psampling.sample_shadow_cmp(shadow, uv, ref)
    want = np.asarray(jsampling.sample_shadow_cmp(
        jnp.zeros((8, 8)), jnp.asarray(uv.numpy()), jnp.asarray(ref.numpy())))
    assert got[0] == 1.0 and got[1] == 1.0 and torch.isnan(got[2])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def lit():
    """The 1024^2 shadow map (where the proof gives a crop) and the
    G-buffer of frame 1 of the lifted atrium, from the port; the same
    frame's globals from both packages."""
    cfg = dict(width=128, height=64, shadow_resolution=1024)
    jb, pb = kit.build_pair("atrium_lifted", jcfg.RenderConfig(**cfg),
                            RenderConfig(**cfg), noise=False)
    assert pb.plan.shadow_crop is not None
    jg, _, _ = jb.frame_globals(1)
    g, mm, nm = pb.frame_globals(1)
    vis, records, smap, _ = pframe.raster_stage(pb.plan, pb.batch, g, mm, nm)
    plan = pb.plan
    gb = pgbuf.resolve_gbuffer(
        vis, records, pb.batch.atlas_packed, g.camera_prev.projection_view,
        atlas_size=plan.atlas_size, layer_stride=plan.atlas_layer_stride,
        n_levels=plan.atlas_n_levels)
    rng = np.random.default_rng(9)
    inputs = dict(depth=vis.depth.numpy(), albedo=gb.albedo.numpy(),
                  emissive=gb.emissive.numpy(), normal=gb.normal.numpy(),
                  ssao=rng.random((64, 128), dtype=np.float32),
                  shadow_map=smap.numpy(),
                  clouds=rng.random((3, 64, 128), dtype=np.float32))
    return jg, g, plan, inputs


ORDER = ("depth", "albedo", "emissive", "normal", "ssao", "shadow_map",
         "clouds")


@pytest.mark.parametrize("crop", [False, True])
def test_compose_volumetric_over_a_rendered_map_matches_jax(lit, crop):
    """compose(enable_volumetric=True) with the rendered 1024^2 map,
    full and through the crop (the volumetric tap reads the full map
    either way).  A march sample whose depth ties a texel's within an
    ulp may flip one of its four comparisons, which moves the pixel by
    up to 1/8 of the phase function; so: mean abs < 1e-6, and max abs
    <= 1e-5 on all but at most 0.1% of the pixels."""
    jg, g, plan, x = lit
    kw = dict(enable_shadow=True, max_point_lights=0, max_spot_lights=0,
              shadow_crop=plan.shadow_crop if crop else None,
              enable_volumetric=True)
    want = np.asarray(jax.jit(lambda g_, *a: jcomp.compose(g_, *a, **kw))(
        jg, *[x[k] for k in ORDER]))
    args = [torch.from_numpy(x[k]) for k in ORDER]
    got = pcomp.compose(g, *args, **kw).numpy()
    d = np.abs(got - want)
    assert np.isfinite(got).all()
    assert (d.max(0) > 1e-5).mean() <= 1e-3, (d.max(0) > 1e-5).mean()
    assert np.median(d) < 1e-6 and d.mean() < 1e-5, (np.median(d), d.mean())
    # the term is there, and it is the map's: it differs from the frame
    # without it, and from the frame that takes the map as all 1.0
    off = pcomp.compose(g, *args, **{**kw, "enable_volumetric": False})
    assert (np.abs(off.numpy() - got).max(0) > 1e-4).mean() > 0.2
    lit_all = pcomp.compose(g, *args[:5], None, args[6],
                            **{**kw, "empty_shadow_map": True,
                               "shadow_crop": None})
    assert (np.abs(lit_all.numpy() - got).max(0) > 1e-4).mean() > 0.01


# ---------------------------------------------------------------- A12

def _ssr_fields(seed):
    """The fields of tests/test_ops.py::test_ssr_compact_matches_dense."""
    rng = np.random.default_rng(seed)
    H, W = 32, 64
    depth = (0.3 + 0.5 * rng.random((H, W), dtype=np.float32))
    albedo = rng.random((3, H, W), dtype=np.float32)
    n = rng.normal(size=(3, H, W)).astype(np.float32)
    normal = n / np.linalg.norm(n, axis=0, keepdims=True)
    metal = (rng.random((H, W)) < 0.3).astype(np.float32)
    mr = np.stack([np.full((H, W), 0.5, np.float32), metal])
    jg, pg = _globals(W, H)
    return (depth, albedo, normal, mr), jg, pg


@pytest.fixture(scope="module", params=[3, 8])
def ssr_case(request):
    f, jg, pg = _ssr_fields(request.param)
    dense = pssr.ssr(*[torch.from_numpy(a) for a in f], pg)
    return f, jg, pg, dense


def test_ssr_dense_matches_jax(ssr_case):
    """The 50-step march against the JAX march on random fields.  Each
    step re-projects the marched position, so an ulp (XLA's FMA) can
    move a ray across the |delta| < 0.05 hit test or the delta > 0
    phase switch and send it elsewhere: `found` agrees on >= 99% of the
    reflective pixels; the colour is held at about three times the
    reading (mean abs 1.4e-7, max 2.4e-5 on both seeds, every `found`
    equal): mean < 5e-7, max < 1e-4; dielectric pixels (albedo passes)
    are equal."""
    f, jg, pg, (got, ov, na) = ssr_case
    want, jov, jna = jax.jit(jssr.ssr)(*f, jg)
    want, got = np.asarray(want), got.numpy()
    assert int(ov) == int(jov) == 0 and int(na) == int(jna) == -1
    metal = f[3][1] >= 0.01
    assert np.array_equal(got[:, ~metal], want[:, ~metal])
    found_j, found_p = want[:, metal].any(0), got[:, metal].any(0)
    assert found_p.mean() > 0.5, found_p.mean()
    assert (found_j == found_p).mean() >= 0.99
    d = np.abs(got - want)
    assert d.mean() < 5e-7 and d.max() < 1e-4, (d.mean(), d.max())


def test_ssr_compact_equals_dense_bit_for_bit(ssr_case):
    f, _, pg, (dense, _, _) = ssr_case
    n_act = int((f[3][1] >= 0.01).sum())
    args = [torch.from_numpy(a) for a in f]
    for cap in (n_act, n_act + 64, 10 ** 9):
        comp, ov, na = pssr.ssr(*args, pg, compact_cap=cap)
        assert int(ov) == 0 and int(na) == n_act
        assert torch.equal(comp, dense)


def test_ssr_over_cap_drops_the_same_pixels_as_jax(ssr_case):
    """Past the cap: the first `cap` reflective pixels in row-major
    order march, the rest are black and flagged; the flag, the count and
    the set of dropped pixels equal the JAX package's."""
    f, jg, pg, (dense, _, _) = ssr_case
    metal = f[3][1] >= 0.01
    n_act = int(metal.sum())
    cap = max(64, n_act // 2)
    tight, ov, na = pssr.ssr(*[torch.from_numpy(a) for a in f], pg,
                             compact_cap=cap)
    jt, jov, jna = jax.jit(lambda *a: jssr.ssr(*a, compact_cap=cap))(*f, jg)
    assert int(ov) == int(jov) == pssr.OVERFLOW_SSR_CAP == 16
    assert int(na) == int(jna) == n_act
    t, d = tight.numpy(), dense.numpy()
    differs = np.any(t != d, axis=0)
    assert differs.any() and np.all(t[:, differs] == 0.0)
    assert np.all(metal[differs])
    order = np.flatnonzero(metal.reshape(-1))
    dropped = np.zeros(metal.size, bool)
    dropped[order[cap:]] = True
    dropped = dropped.reshape(metal.shape)
    assert np.all(t[:, dropped] == 0.0)
    assert np.array_equal(t[:, ~dropped], d[:, ~dropped])
    assert np.all(np.asarray(jt)[:, dropped] == 0.0)


# ---------------------------------------------------------------- A13

@pytest.mark.parametrize("H,W", [(37, 53), (64, 96), (1, 9)])
def test_build_mips_device_matches_jax(H, W):
    """2x2 means down to a 1-texel side, odd sizes dropping their last
    row / column: the same four f32 additions, max abs <= 1e-6."""
    img = np.random.default_rng(H).random((3, H, W), dtype=np.float32)
    want = jdof.build_mips_device(jnp.asarray(img))
    got = pdof.build_mips_device(torch.from_numpy(img))
    assert [tuple(a.shape) for a in got] == [a.shape for a in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("H,W", [(37, 53), (64, 96)])
def test_depth_of_field_matches_jax(H, W):
    """The CoC, the trilinear tap across the mip list and the sky
    branch.  lod = log2(coc * hypot(W, H)) feeds floor(): an ulp of the
    CoC (XLA's FMA, its log2) moves a pixel whose lod sits on an integer
    between two level pairs, which are continuous there, so the bound
    stays at rounding level, about three times the reading (max 1.3e-5,
    mean 5.1e-7): max abs <= 5e-5, mean < 2e-6."""
    rng = np.random.default_rng(W)
    color = rng.random((3, H, W), dtype=np.float32) * 4.0
    depth = (0.5 + 0.5 * rng.random((H, W), dtype=np.float32))
    depth[rng.random((H, W)) < 0.2] = 1.0
    jg, pg = _globals(W, H)
    want = np.asarray(jax.jit(jdof.depth_of_field)(color, depth, jg))
    got = pdof.depth_of_field(torch.from_numpy(color),
                              torch.from_numpy(depth), pg).numpy()
    d = np.abs(got - want)
    assert d.max() <= 5e-5 and d.mean() < 2e-6, (d.max(), d.mean())
    sky = depth == 1.0
    assert np.array_equal(got[:, sky], color[:, sky])
    assert np.abs(got - color)[:, ~sky].mean() > 0.05, "it blurs"


def test_display_attachment_matches_jax():
    """The nearest blit of a half-res target to the output size: the
    same texel indices, so equal."""
    img = np.random.default_rng(2).random((3, 17, 29), dtype=np.float32)
    want = np.asarray(jdof.display_attachment(jnp.asarray(img), 40, 64))
    got = pdof.display_attachment(torch.from_numpy(img), 40, 64).numpy()
    np.testing.assert_array_equal(got, want)
    one = pdof.display_attachment(torch.from_numpy(img[0]), 40, 64)
    np.testing.assert_array_equal(one.numpy()[0], want[0])


# ---------------------------------------------------------------- A14

@pytest.fixture(scope="module")
def sky_inputs():
    """Camera above the ground looking level, so the upper half of the
    (48, 96) depth is sky, the test_sky_pallas.py noise field."""
    W, H = 96, 48
    jg, pg = _globals(W, H, position=(3.0, 2.0, -5.0),
                      elapsed_time=np.float32(3.0))
    depth = np.full((H, W), 1.0, np.float32)
    depth[30:] = 0.9
    return jg, pg, depth, kit.cloud_noise()


@pytest.mark.parametrize("quadrant", [False, True])
def test_render_clouds_matches_jax(sky_inputs, quadrant):
    """The per-pixel march at (24, 48) against the JAX march, with and
    without the QUADRANT quirk.  The bounds are fault C10's (the
    noise-texture LUT, the same march): `_rsi` subtracts squares of
    ~4e13, so single pixels move by up to a percent of the scale;
    median < 1e-5, mean < 1e-3.  Non-sky pixels take the clear colour
    exactly."""
    jg, pg, depth, noise = sky_inputs
    kw = dict(full_width=96, full_height=48) if quadrant else {}
    want = np.asarray(jax.jit(lambda g, d, n: jclouds.render_clouds(
        g, d, n, 48, 24, **kw))(jg, depth, noise))
    got = pclouds.render_clouds(pg, torch.from_numpy(depth),
                                torch.from_numpy(noise), 48, 24, **kw).numpy()
    assert got.shape == want.shape == (3, 24, 48)
    assert np.isfinite(got).all()
    d = np.abs(got - want)
    assert np.median(d) < 1e-5 and d.mean() < 1e-3, (np.median(d), d.mean())
    clear = np.all(want == np.float32([0.2, 0.4, 1.0])[:, None, None], 0)
    assert np.array_equal(got[:, clear], want[:, clear])
    assert (~clear).mean() > (0.9 if quadrant else 0.4)
    assert got[:, ~clear].std() > 1e-3


def test_render_clouds_chunking(sky_inputs):
    """Rows are marched in chunks to bound memory; pixels are
    independent, so the chunk size changes nothing but, on the CPU, which
    elements PyTorch's vectorised exp and sqrt take in their vector body
    and which in their scalar tail: max abs <= 1e-7 (read 1.5e-8, one
    ulp, at scale 1).  On the card it is exact
    (tests/test_torch_cuda.py)."""
    _, pg, depth, noise = sky_inputs
    a = pclouds.render_clouds(pg, torch.from_numpy(depth),
                              torch.from_numpy(noise), 48, 24)
    b = pclouds.render_clouds(pg, torch.from_numpy(depth),
                              torch.from_numpy(noise), 48, 24,
                              rows_per_chunk=7)
    assert (a - b).abs().max().item() <= 1e-7
