"""The sky LUT's two kernels: K6 over the noise texture, K6p over the
procedural value noise.

Counterpart of the JAX package's ``ops/sky_pallas.py``, whose Pallas
``_sky_kernel`` keeps the (64, 64) cloud-noise tile in VMEM and takes
each bilinear-repeat tap as a soft-one-hot MXU product with bf16 noise
and weights.  The CUDA kernel (``kernels/csrc/sky.cu``) computes the
exact XLA oracle instead, ``clouds.render_sky_lut(g, noise_tex=...)``:
a warp per LUT texel, the texel's atmosphere and march samples spread
over its lanes and their sums replayed in that function's order, the
noise tile in shared memory, f32 taps.  That function is the kernel's
plain version.  Without a noise texture the JAX package marches in XLA
(no Pallas kernel); K6p is the same kernel with the hashed value noise
in place of the taps, and ``clouds.render_sky_lut(g)`` its plain
version.
"""
from __future__ import annotations

import torch

from ..kernels import build as kb
from . import clouds

NOISE_N = 64


def sky_params(g):
    """The per-frame scalars of the sky march, (16,) f32 on g's device
    ((B, 16), a row per view, for batched globals): [sun_dir 3 |
    atmosphere origin 3 | camera x, z | elapsed time | cloud drift
    -0.02 * elapsed | sky light 3 | pad 3], each computed by the same
    PyTorch operations as the plain version's."""
    sun_dir = -g.sun.direction
    dev = sun_dir.device
    V = sun_dir.shape[:-1]
    origin = clouds._vec([0.0, 6372e3, 0.0], dev) + g.camera.position
    drift = -clouds.CLOUD_SPEED * g.elapsed_time
    cam = g.camera.position
    return torch.cat([
        sun_dir, origin, cam[..., 0:1], cam[..., 2:3],
        g.elapsed_time.reshape(*V, 1), drift.reshape(*V, 1),
        clouds.sky_light_term(sun_dir),
        torch.zeros((*V, 3), dtype=torch.float32, device=dev)],
        dim=-1).to(torch.float32)


def launch_sky_lut(params, noise_tex=None, lut_w: int = 256,
                   lut_h: int = 128):
    """The sky LUT (3, lut_h, lut_w) of the parameter block `params`
    (sky_params), before the horizon factor: K6 over the (64, 64) cloud
    noise `noise_tex`, or K6p over the procedural value noise where it is
    None; (B, 16) parameters give the B views' LUTs (B, 3, lut_h, lut_w)
    from one launch.  CUDA tensors only."""
    kernel = "sky_lut" if noise_tex is not None else "sky_lut_procedural"
    tensors = (params,) if noise_tex is None else (params, noise_tex)
    kb.choose("cuda", *tensors)
    lib = kb.library()
    if noise_tex is not None and (noise_tex.shape != (NOISE_N, NOISE_N)
                                  or noise_tex.dtype != torch.float32):
        raise ValueError(f"noise_tex {tuple(noise_tex.shape)} "
                         f"{noise_tex.dtype}: want (64, 64) float32")
    if params.shape[-1:] != (16,) or params.dim() > 2 \
            or params.dtype != torch.float32:
        raise ValueError(f"params {tuple(params.shape)} {params.dtype}: "
                         f"want (16,) or (B, 16) float32")
    params = params.contiguous()
    V = params.shape[:-1]
    out = torch.empty((*V, 3, lut_h, lut_w), dtype=torch.float32,
                      device=params.device)
    views, stream = V[0] if V else 1, kb.stream_ptr(params)
    if noise_tex is None:
        code = lib.sky_lut_procedural_launch(
            params.data_ptr(), out.data_ptr(), lut_w, lut_h, views, stream)
    else:
        noise_tex = noise_tex.contiguous()
        code = lib.sky_lut_launch(params.data_ptr(), noise_tex.data_ptr(),
                                  out.data_ptr(), lut_w, lut_h, views,
                                  stream)
    kb.launches[kernel] += 1
    kb.check(code, kernel)
    return out


def _lut_of(g, noise_tex, lut_w: int, lut_h: int):
    """K6 or K6p on g's parameters, the horizon factor applied."""
    out = launch_sky_lut(sky_params(g), noise_tex, lut_w, lut_h)
    horizon = clouds.sky_horizon(-g.sun.direction)
    return out * horizon.reshape(*horizon.shape, 1, 1)


def render_sky_lut_noise(g, noise_tex, lut_w: int = 256, lut_h: int = 128,
                         impl: str | None = None):
    """K6 dispatch: the sky LUT (3, lut_h, lut_w) over the (64, 64) cloud
    noise, horizon factor applied; (B, 3, lut_h, lut_w) from one launch
    for batched globals.  CUDA tensors launch the kernel, CPU tensors (or
    impl="plain") take clouds.render_sky_lut."""
    if kb.choose(impl, noise_tex, g.sun.direction) == "plain":
        return clouds.render_sky_lut(g, lut_w, lut_h, noise_tex=noise_tex)
    return _lut_of(g, noise_tex, lut_w, lut_h)


def render_sky_lut_procedural(g, lut_w: int = 256, lut_h: int = 128,
                              impl: str | None = None):
    """K6p dispatch: the sky LUT (3, lut_h, lut_w) over the procedural
    value noise, horizon factor applied; (B, 3, lut_h, lut_w) from one
    launch for batched globals.  CUDA tensors launch the kernel, CPU
    tensors (or impl="plain") take clouds.render_sky_lut."""
    if kb.choose(impl, g.sun.direction) == "plain":
        return clouds.render_sky_lut(g, lut_w, lut_h)
    return _lut_of(g, None, lut_w, lut_h)
