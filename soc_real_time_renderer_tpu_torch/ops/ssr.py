"""Screen-space reflections (planar), counterpart of the JAX package's
``ops/ssr.py`` (``screen_space_reflection.inl:74-186``): a view-space
ray march (50 iterations, exponential step x1.05, adaptive direction)
followed by a binary-search refinement on the remaining iteration
budget; hit when |delta| < 0.05.  Non-metallic pixels (metallic < 0.01)
pass the albedo through; misses are black (the shader's albedo fallback
is dead code).  The march compares |view z|; the result is computed but
composited only behind ``RenderConfig.composite_ssr``.

On the card the march is K8 (``kernels/csrc/ssr.cu``, one thread a
pixel, each ray returning at its hit); on the CPU, or with
``impl="plain"``, its plain version (:func:`_ssr_plain`), in which the
divergent loop is a masked state machine over ray bundles, 50
dependent steps of plain PyTorch.  Both count ``ssr_pixels``
(``utils/trace``).  ``compact_cap > 0`` marches only the
first ``compact_cap`` reflective pixels in row-major order (each ray
depends on its own pixel alone, so the result equals the dense march
bit for bit); pixels past the cap are black and flagged
(``OVERFLOW_SSR_CAP``).  The compaction is a stable sort of the
reflective mask with a fixed output size: no ``nonzero``, so the call
does not wait for the card.  With a leading view axis the sort, the cap,
the count and the flag are per view (the JAX ``nonzero`` under
``vmap``), and the B views march as one bundle.
"""
from __future__ import annotations

import torch

from . import sampling
from .composition import view_from_depth
from ..kernels import build as kb
from ..utils import trace, views
from ..utils.vec import dot3, normalize3

RAY_STEP = 0.5
ITERATIONS = 50
DISTANCE_BIAS = 0.05
METALLIC_MIN = 0.01      # early-out threshold (inl:175-178)

OVERFLOW_SSR_CAP = 16    # FrameOutputs.overflow bit: reflective pixels
#                          exceeded FramePlan.ssr_cap (dropped rays are
#                          black, never garbage)


def _march(pos, n_view, depth, gp, nv: int):
    """The 50-iteration state machine on ray bundles of any trailing
    shape: pos / n_view (3, *V, ...), depth the full (*V, H, W) screen,
    gp the globals in planar shape for the bundles' pixel axes
    (``views.planar(g, rank)``), nv the number of view axes: each ray
    probes its own view's depth through its own view's projection.
    Returns (found (*V, ...) bool, hit_uv (2, *V, ...))."""
    refl = normalize3(pos - 2.0 * dot3(pos, n_view)[None] * n_view)
    proj = gp.camera.projection
    inv_p = gp.camera.inv_projection

    def probe(p):
        x = proj[0, 0] * p[0] + proj[0, 1] * p[1] + proj[0, 2] * p[2] \
            + proj[0, 3]
        y = proj[1, 0] * p[0] + proj[1, 1] * p[1] + proj[1, 2] * p[2] \
            + proj[1, 3]
        w = proj[3, 0] * p[0] + proj[3, 1] * p[1] + proj[3, 2] * p[2] \
            + proj[3, 3]
        ws = torch.where(w != 0, w, 1.0)
        spos = torch.stack([x / ws * 0.5 + 0.5, y / ws * 0.5 + 0.5])
        sd = sampling.sample_screen(depth, spos, views=nv > 0)
        vz = view_from_depth(spos, sd, inv_p)[2]
        return spos, torch.abs(p[2]) - torch.abs(vz)

    step = refl * RAY_STEP
    mpos = pos + step
    tail = pos.shape[1:]
    phase = torch.zeros(tail, dtype=torch.int32, device=pos.device)
    found = torch.zeros(tail, dtype=torch.bool, device=pos.device)
    hit_uv = torch.zeros((2,) + tail, dtype=torch.float32,
                         device=pos.device)
    for _ in range(ITERATIONS):
        spos, delta = probe(mpos)
        hit = (torch.abs(delta) < DISTANCE_BIAS) & ~found
        found = found | hit
        hit_uv = torch.where(hit[None], spos, hit_uv)

        marching = (phase == 0) & ~found
        to_binary = marching & (delta > 0)
        phase = torch.where(to_binary, 1, phase)
        dsign = torch.sign(delta)
        m_step = step * (1.0 - RAY_STEP * torch.clamp(dsign, min=0.0))[None]
        m_pos = mpos + m_step * (-dsign)[None]
        m_step = m_step * 1.05

        b_step = step * 0.5
        b_pos = mpos - b_step * dsign[None]

        binary = (phase == 1) & ~found
        advance = marching & ~to_binary
        step = torch.where(advance[None], m_step,
                           torch.where(binary[None], b_step, step))
        mpos = torch.where(advance[None], m_pos,
                           torch.where(binary[None], b_pos, mpos))
    return found, hit_uv


def ssr(depth, albedo, normal, metallic_roughness, g, compact_cap: int = 0,
        impl: str | None = None):
    """depth: (*V, H, W); albedo / normal: (*V, 3, H, W);
    metallic_roughness: (*V, 2, H, W) (R = roughness, G = metallic); g
    one frame's globals, or batched ones for a leading view axis (*V).
    Returns ((*V, 3, H, W), overflow (*V,) int32, n_active (*V,) int32).

    compact_cap > 0: march only the first `compact_cap` reflective
    pixels (metallic >= 0.01) of each view in row-major order.  n_active
    is the view's true count of reflective pixels this frame (it sizes
    the cap from data); overflow carries OVERFLOW_SSR_CAP where it
    exceeded the cap (rays past the cap are black).  compact_cap == 0:
    the dense march of every pixel, the same output, n_active -1 and no
    flag.  A batch of views is one march: every operation is elementwise
    or a gather from the ray's own view, so each view equals its
    single-view call bit for bit.

    K8 for CUDA tensors, :func:`_ssr_plain` for CPU tensors (or
    impl="plain"); no fallback.  Counts ``ssr_pixels``, the pixels x
    views marched or passed through, from the shapes (no read-back)."""
    trace.counters["ssr_pixels"] += depth.numel()
    if kb.choose(impl, depth, albedo, normal, metallic_roughness) == "plain":
        return _ssr_plain(depth, albedo, normal, metallic_roughness, g,
                          compact_cap)
    return _ssr_cuda(depth, albedo, normal, metallic_roughness, g,
                     compact_cap)


def _ssr_plain(depth, albedo, normal, metallic_roughness, g,
               compact_cap: int):
    """K8's plain version: :func:`ssr` as masked ray bundles of plain
    PyTorch, the dense march or the compaction by a stable sort."""
    V = depth.shape[:-2]
    nv = len(V)
    H, W = depth.shape[-2:]
    dev = depth.device
    uv = sampling.grid_uv(H, W, dev)
    alb = views.to_planar(albedo, nv)                   # (3, *V, H, W)
    nrm = views.to_planar(normal, nv)
    metallic = metallic_roughness[..., 1, :, :]

    def view_normal(gp, n):
        vm = gp.camera.view[:3, :3]
        return normalize3(torch.stack([
            vm[0, 0] * n[0] + vm[0, 1] * n[1] + vm[0, 2] * n[2],
            vm[1, 0] * n[0] + vm[1, 1] * n[1] + vm[1, 2] * n[2],
            vm[2, 0] * n[0] + vm[2, 1] * n[1] + vm[2, 2] * n[2]]))

    dielectric = (metallic < METALLIC_MIN)[None]
    if compact_cap <= 0:
        gp = views.planar(g, 2)
        pos = view_from_depth(uv, depth, gp.camera.inv_projection)
        found, hit_uv = _march(pos, view_normal(gp, nrm), depth, gp, nv)
        hit_color = sampling.sample_screen(albedo, hit_uv, views=nv > 0)
        out = torch.where(found[None], hit_color, 0.0)
        out = torch.where(dielectric, alb, out)
        return (views.from_planar(out, nv),
                torch.zeros(V, dtype=torch.int32, device=dev),
                torch.full(V, -1, dtype=torch.int32, device=dev))

    gp = views.planar(g, 1)
    P = H * W
    cap = min(compact_cap, P)
    active = (metallic >= METALLIC_MIN).reshape(*V, P)
    n_active = active.sum(-1).to(torch.int32)
    overflow = torch.where(n_active > compact_cap, OVERFLOW_SSR_CAP, 0).to(
        torch.int32)
    # each view's first `cap` reflective pixels in row-major order, then
    # (where fewer are reflective) dielectric ones, whose rays are dropped
    idx = torch.sort((~active).to(torch.uint8), dim=-1,
                     stable=True).indices[..., :cap]          # (*V, cap)
    live = torch.take_along_dim(active, idx, -1)

    def gather(x):                         # (C, *V, P) -> (C, *V, cap)
        return torch.take_along_dim(x, idx[None], -1)

    uvf = uv.reshape(2, P)[:, idx]
    df = torch.take_along_dim(depth.reshape(*V, P), idx, -1)
    nf = gather(nrm.reshape(3, *V, P))
    pos = view_from_depth(uvf, df, gp.camera.inv_projection)
    found, hit_uv = _march(pos, view_normal(gp, nf), depth, gp, nv)

    hit_color = sampling.sample_screen(albedo, hit_uv, views=nv > 0)
    res = torch.where(found[None], hit_color, 0.0)      # (3, *V, cap)
    out = torch.where(dielectric, alb, 0.0).reshape(3, *V, P)
    # a dielectric filler keeps the albedo it already holds
    out.scatter_(-1, idx[None].expand(res.shape),
                 torch.where(live[None], res, gather(out)))
    return (views.from_planar(out.reshape(3, *V, H, W), nv), overflow,
            n_active)


def _ssr_cuda(depth, albedo, normal, metallic_roughness, g, compact_cap: int):
    """K8 on (*V, ...) targets, each of any channel and view strides
    (each H x W plane dense), against the camera's matrices of the
    globals; 0 < compact_cap < H * W ranks the reflective pixels by an
    inclusive prefix sum of each view's mask first (``torch.cumsum``).
    Returns :func:`ssr`'s (image, overflow, n_active)."""
    lib = kb.library()
    V = depth.shape[:-2]
    nv = len(V)
    H, W = depth.shape[-2:]
    P = H * W
    dev = depth.device
    cam = g.camera
    mats = [m.contiguous() for m in (cam.projection, cam.inv_projection,
                                     cam.view)]
    planes = [x if x.stride(-1) == 1 and x.stride(-2) == W
              else x.contiguous()
              for x in (depth, albedo, normal, metallic_roughness)]
    shapes = [(*V, H, W), (*V, 3, H, W), (*V, 3, H, W), (*V, 2, H, W)]
    if nv != g.frame_counter.dim() or nv > 1 \
            or any(tuple(x.shape) != s or x.dtype != torch.float32
                   or x.device != dev for x, s in zip(planes, shapes)) \
            or any(tuple(m.shape) != (*V, 4, 4) or m.device != dev
                   or m.dtype != torch.float32 for m in mats):
        raise ValueError(f"ssr: {[tuple(x.shape) for x in planes]} targets "
                         f"against {[tuple(m.shape) for m in mats]} "
                         f"matrices")
    strides = [planes[0].stride(0) if V else 0]
    for x in planes[1:]:
        strides += [x.stride(-3), x.stride(0) if V else 0]
    if max(strides) >= 2 ** 31 or 3 * depth.numel() >= 2 ** 31:
        raise ValueError(f"ssr: {tuple(depth.shape)} targets are past the "
                         f"kernel's int strides")
    rank = None
    if compact_cap > 0:
        if compact_cap < P:
            rank = (planes[3][..., 1, :, :] >= METALLIC_MIN).reshape(
                *V, P).cumsum(-1, dtype=torch.int32)
        flags = torch.zeros((2, *V), dtype=torch.int32, device=dev)
        n_active, overflow = flags[0], flags[1]
        counts = (n_active.data_ptr(), overflow.data_ptr())
    else:
        overflow = torch.zeros(V, dtype=torch.int32, device=dev)
        n_active = torch.full(V, -1, dtype=torch.int32, device=dev)
        counts = (None, None)
    out = torch.empty((3, *V, P), dtype=torch.float32, device=dev)
    code = lib.ssr_march_launch(
        *(x.data_ptr() for x in planes), *(m.data_ptr() for m in mats),
        None if rank is None else rank.data_ptr(), *counts, out.data_ptr(),
        H, W, V[0] if V else 1, min(max(compact_cap, 0), P),
        16 if V else 0, *strides, kb.stream_ptr(depth))
    kb.check(code, "ssr_march")
    kb.launches["ssr_march"] += 1
    return (views.from_planar(out.reshape(3, *V, H, W), nv), overflow,
            n_active)
