"""Batched multi-camera rendering, the port alone (the comparisons with
the JAX package's ``make_batched_render_fn`` are in
tests/test_torch_parallel.py):

* view i of a batch (B = 3) of the reduced ``atrium_lifted`` against
  ``render_frame`` of view i, and B = 1; the passes that are off by
  default (SSR, depth of field, the volumetric light, the per-pixel
  cloud march) at B = 2;
* the checks the step makes before it renders;
* per-view exposure; the plain kernel versions with a view axis against
  themselves view by view; the sky LUTs with batched globals.

The sky LUT and the SSAO hash are shared as in test_torch_parallel.py:
on the CPU, PyTorch's vectorised transcendental functions round the tail
of a loop unlike its body, so the same pixel can differ in its last bit
between a batched and a single-view call, and the reference hash
multiplies that by 4e4.
"""
import dataclasses

import numpy as np
import pytest
import torch

import torch_scene_kit as kit
from test_torch_parallel import ATRIUM, ORACLE, POSITIONS, \
    _single_vs_batched, luts_seeded, shared_inputs, terrain_port
from soc_real_time_renderer_tpu_torch.config import RenderConfig, SunInfo, \
    select_view, view_count
from soc_real_time_renderer_tpu_torch.graph import frame as pframe
from soc_real_time_renderer_tpu_torch.ops import clouds as pclouds
from soc_real_time_renderer_tpu_torch.ops import exposure as pexposure
from soc_real_time_renderer_tpu_torch.ops import raster2 as praster
from soc_real_time_renderer_tpu_torch.ops import ssao as pssao
from soc_real_time_renderer_tpu_torch.ops import taa as ptaa
from soc_real_time_renderer_tpu_torch.parallel import mesh as pmesh

@pytest.fixture(scope="module")
def port_scenes():
    return {"terrain": terrain_port(RenderConfig(**ORACLE)),
            "atrium_lifted": kit.build_port(
                "atrium_lifted", RenderConfig(**ATRIUM), "cpu")}


def _batched_frames(built, name, B, frames=2):
    """`frames` batched frames of B views of the port alone -> [(colours,
    history, views' globals, model_mats, normal_mats)] per frame."""
    positions = POSITIONS["terrain" if name.startswith("terrain")
                          else "atrium_lifted"][:B]
    step = pmesh.make_batched_render_fn(built.plan)
    hb = pmesh.batched_history([pframe.RenderHistory.create(
        built.plan.config, device="cpu") for _ in range(B)])
    prev = None
    out = []
    for f in range(frames):
        gs, mm, nm = pmesh.view_globals(built, positions, f, prev)
        prev = [g.camera for g in gs]
        colors, hb = step(built.batch, pmesh.batched_globals(gs), hb, mm, nm)
        out.append((colors, hb, gs, mm, nm))
    return out


@pytest.fixture(scope="module")
def atrium_singles():
    """render_frame of atrium_lifted's single views by (view, frame), kept
    across the cases of test_batched_equals_single_views_atrium: view 0
    is in both."""
    return {}


@pytest.mark.parametrize("B", [3, 1])
def test_batched_equals_single_views_atrium(port_scenes, atrium_singles, B):
    """The same on atrium_lifted (each view's 1024^2 shadow map through
    the crop) with B = 3 views of different content, and a batch of one
    view (one frame each: the terrain and the JAX comparisons carry the
    history)."""
    built = port_scenes["atrium_lifted"]
    with pytest.MonkeyPatch.context() as mp:
        shared_inputs(mp, luts_seeded())
        worst = _single_vs_batched(
            built, _batched_frames(built, "atrium_lifted", B, 1),
            atrium_singles)
    assert max(worst) <= 1e-6, worst


@pytest.mark.parametrize("name", ["atrium_passes", "terrain_perpixel"])
def test_off_by_default_passes_batched_equal_single(name):
    """SSR (compacted, composited), depth of field and the volumetric
    light (atrium_passes), and the per-pixel cloud march
    (terrain_perpixel): B = 2 batched against single, max abs <= 1e-6."""
    cfg = RenderConfig(**ATRIUM)
    if name == "atrium_passes":
        cfg = cfg.replace(enable_ssr=True, composite_ssr=True,
                          enable_depth_of_field=True,
                          enable_volumetric_light=True)
    else:
        cfg = cfg.replace(cloud_impl="perpixel", width=64, height=32)
    built = kit.build_port(name, cfg, "cpu")
    with pytest.MonkeyPatch.context() as mp:
        shared_inputs(mp, luts_seeded())
        worst = _single_vs_batched(built, _batched_frames(built, name, 2, 1))
    assert max(worst) <= 1e-6, worst


# --- the checks the step makes before it renders --------------------------

def _refuses(mp, step, *args):
    """`step(*args)` raises ValueError before anything is rendered."""
    def no_render(*a, **k):
        raise AssertionError("rendered before the check")
    mp.setattr(pframe, "raster_stage", no_render)
    with pytest.raises(ValueError):
        step(*args)


def test_step_refuses_a_sun_the_proof_was_not_run_for(port_scenes):
    """Terrain elides the shadow by its proof: a batch with one view
    under another sun raises."""
    built = port_scenes["terrain"]
    assert built.plan.shadow_statically_empty
    gs, mm, nm = pmesh.view_globals(built, POSITIONS["terrain"][:2], 0)
    gs[1] = dataclasses.replace(gs[1], sun=SunInfo.create(
        angle_direction_deg=(12.0, 0.0, 0.0)))
    hb = pmesh.batched_history([pframe.RenderHistory.create(
        built.plan.config, device="cpu") for _ in range(2)])
    with pytest.MonkeyPatch.context() as mp:
        _refuses(mp, pmesh.make_batched_render_fn(built.plan), built.batch,
                 pmesh.batched_globals(gs), hb, mm, nm)


def test_step_refuses_moved_model_matrices(port_scenes):
    """atrium_lifted samples its shadow through a crop proved for its
    model matrices: moved matrices raise (the JAX step does not check,
    see parallel/mesh.py)."""
    built = port_scenes["atrium_lifted"]
    assert built.plan.shadow_crop is not None
    gs, mm, nm = pmesh.view_globals(built, POSITIONS["atrium_lifted"][:2], 0)
    moved = mm.clone()
    moved[..., 1, 3] += 0.5
    hb = pmesh.batched_history([pframe.RenderHistory.create(
        built.plan.config, device="cpu") for _ in range(2)])
    with pytest.MonkeyPatch.context() as mp:
        _refuses(mp, pmesh.make_batched_render_fn(built.plan), built.batch,
                 pmesh.batched_globals(gs), hb, moved, nm)


def test_step_refuses_unbatched_inputs(port_scenes):
    built = port_scenes["terrain"]
    gs, mm, nm = pmesh.view_globals(built, POSITIONS["terrain"][:2], 0)
    one = pframe.RenderHistory.create(built.plan.config, device="cpu")
    step = pmesh.make_batched_render_fn(built.plan)
    with pytest.MonkeyPatch.context() as mp:
        _refuses(mp, step, built.batch, gs[0], one, mm, nm)
        _refuses(mp, step, built.batch, pmesh.batched_globals(gs),
                 pmesh.batched_history([one]), mm, nm)


# --- per-view reductions and the plain kernel versions --------------------

def test_exposure_adapts_per_view(port_scenes):
    """Two views of very different brightness: each view's histogram and
    adaptation are its own (equal to the single-view call), and the two
    exposures move apart, not to a shared value."""
    gs, _, _ = pmesh.view_globals(port_scenes["terrain"],
                            POSITIONS["terrain"][:2], 0)
    gb = pmesh.batched_globals(gs)
    rng = np.random.default_rng(4)
    base = torch.from_numpy(rng.uniform(0.5, 1.5, (2, 3, 32, 48))
                            .astype(np.float32))
    hdr = base * torch.tensor([0.005, 100.0]).reshape(2, 1, 1, 1)
    prev = torch.zeros(2)
    got = pexposure.auto_exposure(hdr, prev, gb)
    singles = [pexposure.auto_exposure(hdr[i], prev[i], gs[i])
               for i in range(2)]
    assert got.shape == (2,)
    for i in range(2):
        assert torch.equal(got[i], singles[i])
    hist = pexposure.luminance_histogram(hdr, gb.log_min_luminance,
                                         gb.log_max_luminance)
    assert hist.shape == (2, 256) and (hist.sum(dim=1) == 32 * 48).all()
    assert (got[0] - got[1]).abs() > 0.1, got


def test_plain_kernels_batched_equal_view_by_view(port_scenes):
    """The plain versions of K1 (the main view), K4 (the sun view), K2
    and K3 with a view axis (B = 3, views of different content) equal the
    same calls view by view, bit for bit."""
    built = port_scenes["atrium_lifted"]
    plan = built.plan
    gs, mm, nm = pmesh.view_globals(built, POSITIONS["atrium_lifted"], 0)
    gb = pmesh.batched_globals(gs)
    world, _ = pframe.transform_triangles(built.batch, mm, nm)
    # the shadow view on a 256^2 grid: the plain resolves are the cost
    sgrid = dataclasses.replace(plan.shadow_grid, width=256, height=256)
    for grid, pv, cull, resolve in (
            (plan.main_grid, gb.camera.projection_view, "front",
             praster.resolve),
            (sgrid, gb.sun.projection_view, "back", praster.resolve_depth)):
        clip = pframe._clip_of(world, pv)
        assert clip.shape[0] == 3
        setup = praster.triangle_setup_planar(clip, grid.width, grid.height,
                                              cull)
        starts, recs, ovf, rgrid = praster.gather_records(setup, grid)
        out = resolve(starts, recs, rgrid)
        out = out if isinstance(out, tuple) else (out,)
        for i in range(3):
            s1 = praster.triangle_setup_planar(pframe._clip_of(world, pv[i]),
                                               grid.width, grid.height, cull)
            st1, rc1, ov1, _ = praster.gather_records(s1, grid)
            assert torch.equal(st1, starts[i]) and torch.equal(rc1, recs[i])
            assert torch.equal(ov1, ovf[i])
            one = resolve(st1, rc1, rgrid)
            one = one if isinstance(one, tuple) else (one,)
            assert all(torch.equal(a, b[i]) for a, b in zip(one, out))
    # K2 and K3 on (B, ...) inputs of different content
    rng = np.random.default_rng(9)
    dep = torch.from_numpy(rng.uniform(0.2, 0.99, (3, 32, 64))
                           .astype(np.float32))
    nrm = torch.from_numpy(rng.normal(size=(3, 3, 32, 64))
                           .astype(np.float32))
    kern = pssao.kernel_vectors(26, "cpu")
    planes = torch.stack([torch.cat(pssao._preamble(dep[i], nrm[i], gs[i]))
                          for i in range(3)])
    bp = torch.cat(pssao._preamble(dep, nrm, gb), dim=0).movedim(0, 1)
    assert torch.equal(bp, planes)
    k2 = pssao.ssao_taps(planes, dep, gb.camera.projection,
                         gb.camera.inv_projection, gb.ssao_radius,
                         gb.ssao_bias, kern)
    for i in range(3):
        assert torch.equal(k2[i], pssao.ssao_taps(
            planes[i], dep[i], gs[i].camera.projection,
            gs[i].camera.inv_projection, gs[i].ssao_radius,
            gs[i].ssao_bias, kern))
    hist = torch.from_numpy(rng.uniform(size=(3, 5, 32, 64))
                            .astype(np.float32)).to(torch.bfloat16)
    vel = torch.from_numpy(rng.normal(0, 0.05, (3, 2, 32, 64))
                           .astype(np.float32))
    k3 = ptaa.reproject_history(hist, vel)
    for i in range(3):
        assert torch.equal(k3[i], ptaa.reproject_history(hist[i], vel[i]))


def test_sky_lut_batched_equals_view_by_view(port_scenes):
    """K6's plain version (the noise-texture LUT) and the procedural LUT
    with batched globals: a LUT per view, each equal to the single-view
    call (a 32x16 LUT; its march is ill-conditioned, so the reading is
    stated: measured max abs / peak 0 on the CPU)."""
    gs, _, _ = pmesh.view_globals(port_scenes["terrain"], POSITIONS["terrain"], 0)
    gs = [dataclasses.replace(g, elapsed_time=torch.tensor(0.7 * i))
          for i, g in enumerate(gs)]
    gb = pmesh.batched_globals(gs)
    noise = torch.from_numpy(kit.cloud_noise())
    for tex in (noise, None):
        lut = pclouds.render_sky_lut(gb, 32, 16, noise_tex=tex)
        assert lut.shape == (3, 3, 16, 32)
        peak = lut.abs().max().item()
        for i in range(3):
            one = pclouds.render_sky_lut(gs[i], 32, 16, noise_tex=tex)
            assert (one - lut[i]).abs().max().item() <= 1e-6 * peak
        assert (lut[0] - lut[1]).abs().max() > 1e-3 * peak


def test_single_view_select_round_trips(port_scenes):
    gs, _, _ = pmesh.view_globals(port_scenes["terrain"], POSITIONS["terrain"], 1)
    gb = pmesh.batched_globals(gs)
    assert view_count(gs[0]) is None and view_count(gb) == 3
    back = select_view(gb, 2)
    assert torch.equal(back.camera.view, gs[2].camera.view)
    assert torch.equal(back.lights.point_position,
                       gs[2].lights.point_position)
