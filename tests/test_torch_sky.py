"""The noise-texture sky LUT (K6), port against the JAX package, at 128x16
with the synthetic noise field of tests/test_sky_pallas.py: the port's
``clouds.render_sky_lut(g, noise_tex=...)`` (K6's plain version, and
what ``sky.render_sky_lut_noise`` runs on CPU tensors) against the JAX
exact LUT and the JAX Pallas kernel in interpret mode.  Then the
procedural LUT's kernel (K6p) as far as the CPU reaches it: its wrapper
takes ``clouds.render_sky_lut(g)`` on CPU tensors, the frame routes a
scene without the noise texture to it, and the kernels' ctypes
signatures match the exported launch functions of ``kernels/csrc``.
"""
import ctypes
import dataclasses
import glob
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_scene_kit as kit
from soc_real_time_renderer_tpu import config as jcfg
from soc_real_time_renderer_tpu.camera import Camera3D, camera_matrices
from soc_real_time_renderer_tpu.ops import clouds as jclouds
from soc_real_time_renderer_tpu.ops import sky_pallas
from soc_real_time_renderer_tpu_torch import convert
from soc_real_time_renderer_tpu_torch.config import RenderConfig
from soc_real_time_renderer_tpu_torch.graph import frame as pframe
from soc_real_time_renderer_tpu_torch.kernels import build as kb
from soc_real_time_renderer_tpu_torch.ops import clouds as pclouds
from soc_real_time_renderer_tpu_torch.ops import sky as psky
from soc_real_time_renderer_tpu_torch.parallel import mesh as pmesh

LUT_W, LUT_H = 128, 16


@pytest.fixture(scope="module")
def inputs():
    """(JAX globals, port globals, noise) as in test_sky_pallas.py."""
    cam = Camera3D()
    cam.resize(256, 128)
    jg = jcfg.ShaderGlobals.create(
        camera=camera_matrices(cam, [0.0, 2.0, 0.0], 1, 256, 128),
        elapsed_time=jnp.float32(3.0))
    return jg, convert.globals_from_numpy(jg), kit.cloud_noise()


@pytest.fixture(scope="module")
def port_lut(inputs):
    _, g, noise = inputs
    lut = psky.render_sky_lut_noise(g, torch.from_numpy(noise), LUT_W, LUT_H)
    assert torch.equal(lut, pclouds.render_sky_lut(
        g, LUT_W, LUT_H, noise_tex=torch.from_numpy(noise)))
    assert lut.shape == (3, LUT_H, LUT_W) and torch.isfinite(lut).all()
    return lut.numpy()


def test_noise_sky_lut_matches_jax_exact(inputs, port_lut):
    """Against the JAX exact LUT (jit): median < 1e-5 and mean < 1e-3,
    the procedural LUT's median bound and a mean bound 50x tighter than
    its 0.05 (test_torch_ops.py::test_render_sky_lut): the noise texture
    has no sin hash to amplify an ulp, and what differs is the
    atmosphere and the cloud shells' ray intersections, which subtract
    ~4e13-sized squares (ROADMAP fault C6), under XLA's FMA contraction.
    Measured: median 1.2e-6, mean 1.3e-4."""
    jg, _, noise = inputs
    want = np.asarray(jax.jit(lambda g_, n: jclouds.render_sky_lut(
        g_, LUT_W, LUT_H, noise_tex=n))(jg, noise))
    d = np.abs(port_lut - want)
    assert np.median(d) < 1e-5 and d.mean() < 1e-3, (np.median(d), d.mean())


def test_noise_sky_lut_matches_jax_pallas(inputs, port_lut):
    """Against the TPU kernel in interpret mode (bf16 noise and weights
    in its MXU taps): that test's bounds, max/scale < 0.03 and
    mean/scale < 0.005."""
    jg, _, noise = inputs
    want = np.asarray(sky_pallas.render_sky_lut_pallas(
        jg, jnp.asarray(noise), lut_w=LUT_W, lut_h=LUT_H, interpret=True))
    d = np.abs(port_lut - want)
    scale = max(np.abs(want).max(), 1e-3)
    assert d.max() / scale < 0.03 and d.mean() / scale < 0.005, \
        (d.max() / scale, d.mean() / scale)


def test_sky_params_are_the_plain_versions_scalars(inputs):
    """K6's parameter block holds the plain version's own per-frame
    terms: sun direction, atmosphere origin, camera x/z, time, drift and
    sky light."""
    _, g, _ = inputs
    p = psky.sky_params(g)
    sun = -g.sun.direction
    assert p.shape == (16,) and p.dtype == torch.float32
    assert torch.equal(p[0:3], sun)
    assert torch.equal(p[6:8], g.camera.position[[0, 2]])
    assert torch.equal(p[10:13], pclouds.sky_light_term(sun))
    assert float(p[9]) == float(-pclouds.CLOUD_SPEED * g.elapsed_time)


def test_noise_sky_lut_repeats(inputs, port_lut):
    """Two more calls of the noise LUT return the first call's tensor
    bit for bit: the constants shared between calls are never written."""
    _, g, noise = inputs
    for _ in range(2):
        again = psky.render_sky_lut_noise(g, torch.from_numpy(noise), LUT_W,
                                          LUT_H)
        assert np.array_equal(again.numpy(), port_lut)


@pytest.mark.parametrize("values", [pclouds.RAYLEIGH, pclouds.MIE,
                                    [0.0, 6372e3, 0.0], 1.99],
                         ids=["rayleigh", "mie", "origin", "scalar"])
def test_cached_constants(values):
    """ops/clouds._vec: the cached constant equals a freshly made tensor
    bit for bit, is float32, is the same object on a second request
    (list or tuple, device by name or object), and lives on the device
    asked for: another device gets a tensor of its own."""
    fresh = torch.tensor(values, dtype=torch.float32)
    cached = pclouds._vec(values, "cpu")
    assert cached.dtype == torch.float32 and cached.device.type == "cpu"
    assert torch.equal(cached, fresh)
    again = tuple(values) if isinstance(values, list) else values
    assert pclouds._vec(again, torch.device("cpu")) is cached
    meta = pclouds._vec(values, "meta")
    assert meta.device.type == "meta" and meta.shape == fresh.shape
    assert pclouds._vec(values, "cpu") is cached


def test_sky_params_block_keeps_its_bits(inputs):
    """K6's parameter block from the cached constants equals the block
    assembled from freshly made tensors, bit for bit."""
    _, g, _ = inputs
    sun = -g.sun.direction
    f32 = dict(dtype=torch.float32)
    total = torch.tensor(pclouds.RAYLEIGH, **f32) \
        + torch.tensor(pclouds.MIE, **f32)
    od = 100000.0 / torch.tensor(1.99, **f32)
    odl = pclouds._particle_thickness(sun[1])
    absorb_sun = pclouds._d02(
        pclouds._absorb(total, odl) - pclouds._absorb(total, od)) \
        / pclouds._d02((total * odl - total * od) * pclouds.LN2)
    scatter_sun = torch.tensor(pclouds.MIE, **f32) * od * 0.25 \
        + torch.tensor(pclouds.RAYLEIGH, **f32) * od * 0.375
    light = scatter_sun * absorb_sun * pclouds.SUN_BRIGHTNESS * 0.25 / np.pi
    origin = torch.tensor([0.0, 6372e3, 0.0], **f32) + g.camera.position
    p = psky.sky_params(g)
    assert torch.equal(p[3:6], origin)
    assert torch.equal(p[10:13], light)
    assert torch.equal(p[13:], torch.zeros(3))


def _batched(g, n):
    """n copies of one frame's globals as batched globals, each view
    with its own elapsed time and camera height."""
    gs = []
    for i in range(n):
        cam = dataclasses.replace(
            g.camera, position=g.camera.position + torch.tensor(
                [0.0, 3.0 * i, 0.0]))
        gs.append(dataclasses.replace(g, camera=cam,
                                      elapsed_time=g.elapsed_time + 40.0 * i))
    return pmesh.batched_globals(gs)


@pytest.mark.parametrize("impl", [None, "plain"], ids=["auto", "plain"])
@pytest.mark.parametrize("views", [0, 2], ids=["single", "batched"])
def test_procedural_sky_lut_takes_the_plain_version_on_cpu(inputs, views,
                                                           impl):
    """K6p's wrapper on CPU tensors (impl None or "plain") is
    clouds.render_sky_lut(g) bit for bit, for one frame's globals and
    for batched ones, and launches nothing."""
    _, g, _ = inputs
    if views:
        g = _batched(g, views)
    kb.reset_launches()
    got = psky.render_sky_lut_procedural(g, 32, 16, impl=impl)
    want = pclouds.render_sky_lut(g, 32, 16)
    assert got.shape == (*((views,) if views else ()), 3, 16, 32)
    assert torch.equal(got, want) and torch.isfinite(got).all()
    assert not any(kb.launches.values())
    with pytest.raises(ValueError):
        psky.render_sky_lut_procedural(g, 32, 16, impl="cuda")


@pytest.mark.parametrize("noise,mode,want", [
    (None, "texture", "procedural"),
    ("field", "procedural", "procedural"),
    ("field", "texture", "noise")])
def test_frame_sky_lut_routes_by_the_noise(inputs, monkeypatch, noise, mode,
                                           want):
    """graph/frame._sky_lut: without the noise texture, or with the
    procedural noise mode, the frame's LUT is K6p's wrapper; with the
    texture, K6's; the impl is handed on."""
    _, g, field = inputs
    calls = []
    monkeypatch.setattr(psky, "render_sky_lut_procedural",
                        lambda g_, **k: calls.append(("procedural", k)))
    monkeypatch.setattr(psky, "render_sky_lut_noise",
                        lambda g_, n, **k: calls.append(("noise", k)))
    tex = None if noise is None else torch.from_numpy(field)
    pframe._sky_lut(RenderConfig(cloud_noise_mode=mode), g, tex, "plain")
    assert calls == [(want, {"impl": "plain"})]


def _exports():
    """{name: [ctypes type of each argument]} of every launch function
    the CUDA sources export (`void*` a pointer, `int` an int)."""
    out = {}
    for path in glob.glob(os.path.join(kb.CSRC, "*.cu")):
        with open(path) as f:
            src = f.read()
        for name, args in re.findall(
                r"SOC_EXPORT\s+int\s+(\w+)\s*\(([^)]*)\)", src):
            out[name] = [ctypes.c_void_p if "*" in a else ctypes.c_int
                         for a in args.split(",")]
    return out


@pytest.mark.parametrize("name", sorted(kb._SIGNATURES))
def test_launch_signatures_match_the_sources(name):
    """Each launch function's ctypes argtypes in kernels/build.py are its
    exported C signature's, argument by argument; every exported launch
    function is declared.  K6p's entry takes params and out, three ints
    (lut_w, lut_h, views) and the stream."""
    exports = _exports()
    assert sorted(exports) == sorted(kb._SIGNATURES)
    assert kb._SIGNATURES[name] == exports[name]
    if name == "sky_lut_procedural_launch":
        P, I = ctypes.c_void_p, ctypes.c_int
        assert kb._SIGNATURES[name] == [P, P, I, I, I, P]
        assert "sky_lut_procedural" in kb.launches
