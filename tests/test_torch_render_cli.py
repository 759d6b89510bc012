"""The port's headless render CLI (``python -m
soc_real_time_renderer_tpu_torch.tools.render``) on the CPU, called in
process through ``main(argv)``: the reduced terrain (a 64^2 heightmap PNG
through ``SOC_TERRAIN_HEIGHTMAP``, tess level 1), 128x64, two frames.

The PNG it writes is its last frame's ``to_srgb_u8`` exactly, and within
the terrain frame test's bounds (tests/test_torch_frame.py: colour mean
abs < 2e-3, 99.9th percentile < 3e-2, here in 8-bit sRGB levels) of the
JAX package's ``render_frame`` colour of the same scene, the JAX package
on its oracle plan; the sky LUT of each frame and the SSAO noise hash
are shared, as in that test.  ``--dump-passes`` writes the pass files,
``--pair-cap`` prints the overflow warning.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soc_real_time_renderer_tpu import config as jcfg
from soc_real_time_renderer_tpu import scenes as jscenes
from soc_real_time_renderer_tpu.graph import frame as jframe
from soc_real_time_renderer_tpu.ops import clouds as jclouds
from soc_real_time_renderer_tpu.ops import ssao as jssao
from soc_real_time_renderer_tpu.utils import image_io as jimage_io
from soc_real_time_renderer_tpu_torch import scenes as pscenes
from soc_real_time_renderer_tpu_torch.ops import clouds as pclouds
from soc_real_time_renderer_tpu_torch.ops import ssao as pssao
from soc_real_time_renderer_tpu_torch.tools import render
from soc_real_time_renderer_tpu_torch.utils import image_io as pimage_io
from soc_real_time_renderer_tpu_torch.utils import png

W, H = 128, 64
ARGS = ["--scene", "terrain", "--width", str(W), "--height", str(H),
        "--device", "cpu"]


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """(the CLI's last FrameOutputs, its PNG path, the JAX colour of the
    same frame, a path for the capped run's PNG)."""
    tmp = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(5)
    # 64^2, blocky, heights below 0.32: the peaks stay under the sun's
    # volume, so the shadow is proved empty as in the default terrain
    hm = (rng.random((8, 8)) * 80).astype(np.uint8)
    hm = np.kron(hm, np.ones((8, 8), np.uint8))
    (tmp / "hm.png").write_bytes(png.encode_png(hm, filter_type=2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SOC_TERRAIN_HEIGHTMAP", str(tmp / "hm.png"))
        mp.delenv("SOC_TERRAIN_ALBEDO", raising=False)
        mp.setattr(jscenes, "ASSETS", str(tmp))           # no noise PNG
        mp.setattr(pscenes, "ASSETS", str(tmp))
        for mod in (jscenes, pscenes):
            mp.setattr(mod, "_terrain_model", functools.partial(
                mod._terrain_model, tess_level=1))
        mp.setattr(jssao, "_rand",
                   lambda cu, cv: 0.5 + 0.5 * jnp.sin(cu * 0.7 + cv * 1.3))
        mp.setattr(pssao, "_rand",
                   lambda cu, cv: 0.5 + 0.5 * torch.sin(cu * 0.7 + cv * 1.3))
        jb = jscenes.build("terrain", jcfg.RenderConfig(
            width=W, height=H, ssao_impl="xla", taa_impl="xla"))
        plan = dataclasses.replace(
            jb.plan, rec_pack="f32", interpret=True, texture_impl="xla",
            main_grid=dataclasses.replace(jb.plan.main_grid,
                                          rec_dtype="f32"))
        lut_fn = jax.jit(jclouds.render_sky_lut)
        luts = [np.asarray(lut_fn(jb.frame_globals(f, peek=True)[0]))
                for f in (0, 1)]
        mp.setattr(jclouds, "render_sky_lut",
                   lambda g_, *a, **k: jnp.where(g_.frame_counter == 0,
                                                 luts[0], luts[1]))
        mp.setattr(pclouds, "render_sky_lut",
                   lambda g_, *a, **k: torch.from_numpy(
                       luts[int(g_.frame_counter)].copy()))
        run = jax.jit(lambda b, g, h, m, n: jframe.render_frame(
            plan, b, g, h, m, n))
        jh = jframe.RenderHistory.create(plan.config)
        for f in range(2):
            jg, jmm, jnm = jb.frame_globals(f)
            jo, jh = run(jb.batch, jg, jh, jmm, jnm)
        out = str(tmp / "out" / "frame.png")
        outputs = render.main(ARGS + ["--frames", "2", "--out", out,
                                      "--dump-passes"])
        capped = tmp / "capped.png"
        return outputs, out, np.asarray(jo.color), capped


def test_cli_png_is_its_last_frame(cli):
    outputs, out, _, _ = cli
    img = png.decode_png(open(out, "rb").read())
    assert img.shape == (H, W, 4) and (img[..., 3] == 255).all()
    assert img[..., :3].tobytes() == pimage_io.to_srgb_u8(
        outputs.color).tobytes()
    assert int(outputs.overflow) == 0 and img[..., :3].std() > 1.0


def test_cli_png_matches_the_jax_frame(cli):
    """The CLI's PNG against the JAX colour through the JAX package's
    to_srgb_u8: mean < 2e-3 * 255 and 99.9th percentile < 3e-2 * 255
    levels."""
    _, out, jcolor, _ = cli
    got = png.decode_png(open(out, "rb").read())[..., :3].astype(np.int64)
    d = np.abs(got - jimage_io.to_srgb_u8(jcolor).astype(np.int64))
    assert d.mean() < 2e-3 * 255, d.mean()
    assert np.quantile(d, 0.999) < 3e-2 * 255, np.quantile(d, 0.999)


def test_cli_dumps_passes(cli):
    _, out, _, _ = cli
    base = os.path.splitext(out)[0]
    for name in ("albedo", "emissive", "normal", "depth", "velocity",
                 "hdr"):
        img = png.decode_png(open(f"{base}_{name}.png", "rb").read())
        assert img.shape == (H, W, 4), name
    assert not os.path.exists(f"{base}_shadow.png")   # proved empty


def test_cli_pair_cap_warns(cli, capsys):
    """--pair-cap below the frame's pairs: the overflow warning, and
    still a PNG."""
    _, _, _, capped = cli
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pscenes, "_terrain_model", functools.partial(
            pscenes._terrain_model, tess_level=1))
        mp.setattr(pclouds, "render_sky_lut", lambda g_, *a, **k:
                   torch.zeros((3, 128, 256)))
        outputs = render.main(ARGS + ["--pair-cap", "256", "--out",
                                      str(capped)])
    said = capsys.readouterr().out
    assert "WARNING: static caps overflowed (PAIRS" in said, said
    assert int(outputs.overflow) & 1 and capped.exists()
    assert "frame 0:" in said and f"wrote {capped}" in said
