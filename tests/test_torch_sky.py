"""The noise-texture sky LUT (K6), port against the JAX package, at 128x16
with the synthetic noise field of tests/test_sky_pallas.py: the port's
``clouds.render_sky_lut(g, noise_tex=...)`` (K6's plain version, and
what ``sky.render_sky_lut_noise`` runs on CPU tensors) against the JAX
exact LUT and the JAX Pallas kernel in interpret mode.
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
from soc_real_time_renderer_tpu.ops import sky_pallas
from soc_real_time_renderer_tpu_torch import convert
from soc_real_time_renderer_tpu_torch.ops import clouds as pclouds
from soc_real_time_renderer_tpu_torch.ops import sky as psky

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
