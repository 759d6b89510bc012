"""The passes that are off by default in whole frames, port against the
JAX package on the CPU: two frames of the reduced ``atrium_passes`` and
``terrain_perpixel`` scenes (tests/torch_scene_kit.py) with those
switches on, rendered once per module (``passes_frames``,
``perpixel_frames``) and read by every test of them; then, inside the
port, the per-pixel march without the noise field.  The ops alone are in
tests/test_torch_passes.py, the SSR cap and the passes' switches inside
the port in tests/test_torch_passes_cap.py.  XLA's CPU jit contracts
``a*b + c`` into FMA and the port does not, so bounds are ulp-level,
not bitwise (ROADMAP fault C7).
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_scene_kit as kit
from soc_real_time_renderer_tpu import config as jcfg
from soc_real_time_renderer_tpu.graph import frame as jframe
from soc_real_time_renderer_tpu.ops import ssao as jssao
from soc_real_time_renderer_tpu_torch.config import RenderConfig
from soc_real_time_renderer_tpu_torch.graph import frame as pframe
from soc_real_time_renderer_tpu_torch.ops import ssao as pssao

ORACLE = dict(width=128, height=64, shadow_resolution=512, ssao_impl="xla",
              taa_impl="xla")
SWITCHES = {
    "atrium_passes": dict(enable_ssr=True, composite_ssr=True,
                          enable_depth_of_field=True,
                          enable_volumetric_light=True),
    "terrain_perpixel": dict(cloud_impl="perpixel"),
}


def _render_both(name, ssr_cap=0):
    """[(jax outputs, port outputs)] of frames 0 and 1 of scene `name`
    with its switches on, the JAX package on its exact oracle plan (as
    tests/test_torch_scenes.py), the SSAO hash the smooth one in both."""
    cfg = {**ORACLE, **SWITCHES[name]}
    jb, pb = kit.build_pair(name, jcfg.RenderConfig(**cfg),
                            RenderConfig(**cfg))
    jplan = dataclasses.replace(
        jb.plan, rec_pack="f32", interpret=True, texture_impl="xla",
        ssr_cap=ssr_cap,
        main_grid=dataclasses.replace(jb.plan.main_grid, rec_dtype="f32"),
        shadow_grid=dataclasses.replace(jb.plan.shadow_grid,
                                        rec_dtype="f32"))
    pplan = dataclasses.replace(pb.plan, ssr_cap=ssr_cap)
    out = []
    jh = jframe.RenderHistory.create(jplan.config)
    ph = pframe.RenderHistory.create(pplan.config, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jssao, "_rand",
                   lambda cu, cv: 0.5 + 0.5 * jnp.sin(cu * 0.7 + cv * 1.3))
        mp.setattr(pssao, "_rand",
                   lambda cu, cv: 0.5 + 0.5 * torch.sin(cu * 0.7 + cv * 1.3))
        render = jax.jit(lambda b, g, h, m, n: jframe.render_frame(
            jplan, b, g, h, m, n))
        for f in range(2):
            jg, jmm, jnm = jb.frame_globals(f)
            jo, jh = render(jb.batch, jg, jh, jmm, jnm)
            pg, pmm, pnm = pb.frame_globals(f)
            po, ph = pframe.render_frame(pplan, pb.batch, pg, ph, pmm, pnm)
            out.append((jo, po))
    return pplan, out


@pytest.fixture(scope="module")
def passes_frames():
    return _render_both("atrium_passes", ssr_cap=4096)


@pytest.fixture(scope="module")
def perpixel_frames():
    return _render_both("terrain_perpixel")


def _image_bounds(jo, po, target, mean, p999):
    got = getattr(po, target).numpy()
    d = np.abs(np.asarray(getattr(jo, target)) - got)
    assert np.isfinite(got).all() and got.std() > 1e-3
    assert d.mean() < mean, d.mean()
    assert np.quantile(d, 0.999) < p999, np.quantile(d, 0.999)


@pytest.mark.parametrize("frame", [0, 1])
@pytest.mark.parametrize("target", ["hdr", "color"])
def test_atrium_passes_image_matches(passes_frames, frame, target):
    """SSR (compacted, composited), DoF and the volumetric light over
    the rendered 512^2 map, on the lifted atrium with a metallic floor:
    tests/test_torch_scenes.py's bounds, mean abs < 2e-4 and 99.9th
    percentile < 1e-2 (read: mean <= 1.9e-5, p99.9 <= 1.1e-3)."""
    _, out = passes_frames
    _image_bounds(*out[frame], target, 2e-4, 1e-2)


def test_atrium_passes_ssr_target(passes_frames):
    """The SSR target and its bookkeeping: the reflective-pixel count
    equals the JAX package's, is > 1% of the pixels and under the cap
    (no flag), some ray found a hit, and the target's mean abs is
    < 1e-6 (read 2.4e-7: the flat materials' albedo differs by an ulp
    between the packages' texture taps, hits and misses agree)."""
    plan, out = passes_frames
    for jo, po in out:
        n = int(po.ssr_active)
        assert n == int(jo.ssr_active) and 0.01 * 128 * 64 < n <= plan.ssr_cap
        assert int(po.overflow) == int(jo.overflow) == 0
        metal = po.gbuffer.metallic_roughness[1] >= 0.01
        assert int(metal.sum()) == n
        assert po.ssr[:, metal].any(0).float().mean() > 0.02
        d = np.abs(po.ssr.numpy() - np.asarray(jo.ssr))
        assert d.mean() < 1e-6, d.mean()


@pytest.mark.parametrize("frame", [0, 1])
@pytest.mark.parametrize("target", ["hdr", "color", "clouds"])
def test_terrain_perpixel_image_matches(perpixel_frames, frame, target):
    """The reduced terrain with the cloud-noise field and
    cloud_impl="perpixel": a third of the half-res pixels are sky.  The
    clouds target at median < 1e-5 (fault C10's) and mean < 5e-5 (read
    1.2e-5, max 4.8e-3: `_rsi`'s cancellation moves single pixels); hdr
    and colour at tests/test_torch_scenes.py's bounds, mean abs < 2e-4
    and 99.9th percentile < 1e-2 (read 9.6e-6 and 1.2e-3)."""
    _, out = perpixel_frames
    jo, po = out[frame]
    if target == "clouds":
        got = po.clouds.numpy()
        d = np.abs(got - np.asarray(jo.clouds))
        assert np.isfinite(got).all()
        assert np.median(d) < 1e-5 and d.mean() < 5e-5, d.mean()
        sky = (got != np.float32([0.2, 0.4, 1.0])[:, None, None]).any(0)
        assert sky.mean() > 0.1, sky.mean()
    else:
        _image_bounds(jo, po, target, 2e-4, 1e-2)


def test_perpixel_makes_no_lut_and_missing_noise_warns(monkeypatch):
    """With the noise field the per-pixel path makes no sky LUT (K6's
    wrapper is not called); without it the frame warns and takes the
    LUT path, as the JAX package does."""
    cfg = RenderConfig(**{**ORACLE, "cloud_impl": "perpixel"})
    pb = kit.build_port("terrain_perpixel", cfg, "cpu")
    g, mm, nm = pb.frame_globals(0)
    hist = pframe.RenderHistory.create(cfg, device="cpu")
    calls = []
    from soc_real_time_renderer_tpu_torch.ops import sky as psky
    real = psky.render_sky_lut_noise
    monkeypatch.setattr(psky, "render_sky_lut_noise",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out, _ = pframe.render_frame(pb.plan, pb.batch, g, hist, mm, nm)
    assert not calls and torch.isfinite(out.color).all()
    bare = dataclasses.replace(pb.batch, cloud_noise=None)
    with pytest.warns(UserWarning, match="perpixel.*falling back"):
        lut_out, _ = pframe.render_frame(pb.plan, bare, g, hist, mm, nm)
    assert torch.isfinite(lut_out.color).all()
    assert not torch.equal(lut_out.clouds, out.clouds)
