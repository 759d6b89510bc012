"""The slice as a whole: the two multi-entity scenes, reduced, built by both
packages and two frames of each rendered by both (frame_counter 0 and 1,
so TAA reads history).

* ``full_nohelmet``: the small atrium (five flat materials) at scale
  0.01 plus the 64^2-heightmap terrain at y = -8, animated camera; the
  shadow is proved empty; the six-material atlas takes the K5 tap.
* ``atrium_lifted``: the small atrium at y = 32, inside the sun's
  volume: the 512^2 shadow view is rastered (K4) and sampled.

Both carry the synthetic cloud-noise field (K6's path).  128x64 output,
64^2 atlas.  The JAX package runs its exact oracle plan (ssao_impl,
taa_impl and texture_impl "xla", f32 records in both bin grids, Pallas
in interpret mode), the port its plain PyTorch kernel versions on the
CPU.  The SSAO noise hash is a smooth one in both packages, as in
test_torch_frame.py (the reference's is ill-conditioned in f32, ROADMAP
fault C6); the sky LUT is not shared: the camera is inside the closed
atrium, so no pixel shows the sky.
"""
import dataclasses

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


@pytest.fixture(scope="module", params=sorted(kit.SCENES))
def frames(request):
    """(scene name, port plan, [(jax outputs, jax history, port outputs,
    port history)] for frames 0 and 1)."""
    jb, pb = kit.build_pair(request.param, jcfg.RenderConfig(**ORACLE),
                            RenderConfig(**ORACLE))
    plan = dataclasses.replace(
        jb.plan, rec_pack="f32", interpret=True, texture_impl="xla",
        main_grid=dataclasses.replace(jb.plan.main_grid, rec_dtype="f32"),
        shadow_grid=dataclasses.replace(jb.plan.shadow_grid,
                                        rec_dtype="f32"))
    out = []
    jh = jframe.RenderHistory.create(plan.config)
    ph = pframe.RenderHistory.create(pb.plan.config, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jssao, "_rand",
                   lambda cu, cv: 0.5 + 0.5 * jnp.sin(cu * 0.7 + cv * 1.3))
        mp.setattr(pssao, "_rand",
                   lambda cu, cv: 0.5 + 0.5 * torch.sin(cu * 0.7 + cv * 1.3))
        render = jax.jit(lambda b, g, h, m, n: jframe.render_frame(
            plan, b, g, h, m, n))
        for f in range(2):
            jg, jmm, jnm = jb.frame_globals(f)
            jo, jh = render(jb.batch, jg, jh, jmm, jnm)
            pg, pmm, pnm = pb.frame_globals(f)
            po, ph = pframe.render_frame(pb.plan, pb.batch, pg, ph, pmm, pnm)
            out.append((jo, jh, po, ph))
    return request.param, pb.plan, out


def test_scene_takes_its_kernels_path(frames):
    name, plan, out = frames
    assert plan.atlas_num_materials >= 2
    for jo, _, po, _ in out:
        assert int(jo.overflow) == int(po.overflow) == 0
        if name == "atrium_lifted":
            assert (po.shadow_map < 1.0).float().mean() > 0.1


@pytest.mark.parametrize("frame", [0, 1])
@pytest.mark.parametrize("target", ["hdr", "color"])
def test_image_matches(frames, frame, target):
    """mean abs < 2e-4 and 99.9th percentile < 1e-2, ten and three times
    tighter than the terrain slice's bounds (test_torch_frame.py), which
    share the sky LUT to get there; these scenes need no sharing, as no
    pixel shows the sky.  Measured: mean <= 2.3e-5, p99.9 <= 1.3e-3."""
    _, _, out = frames
    jo, _, po, _ = out[frame]
    got = getattr(po, target).numpy()
    d = np.abs(np.asarray(getattr(jo, target)) - got)
    assert np.isfinite(got).all() and got.std() > 1e-3
    assert d.mean() < 2e-4, d.mean()
    assert np.quantile(d, 0.999) < 1e-2, np.quantile(d, 0.999)


def test_shadow_map_matches(frames):
    """The rendered shadow map of both frames: coverage agreement >=
    0.999 and depth within 1e-4 on >= 99.9% of the texels both cover
    (see test_torch_shadow.py for why not a max bound); full_nohelmet's
    map is proved empty and rendered by neither package."""
    name, _, out = frames
    for jo, _, po, _ in out:
        if name == "full_nohelmet":
            assert jo.shadow_map is None and po.shadow_map is None
            continue
        jd, pd = np.asarray(jo.shadow_map), po.shadow_map.numpy()
        assert ((jd < 1.0) == (pd < 1.0)).mean() >= 0.999
        both = (jd < 1.0) & (pd < 1.0)
        assert (np.abs(jd - pd)[both] <= 1e-4).mean() >= 0.999
