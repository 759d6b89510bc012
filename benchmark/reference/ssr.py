"""Screen-space reflections, the reference: the dense march of every pixel.

The semantics of ``screen_space_reflection.inl:74-186`` as the port's
``ops/ssr.py`` and PARITY.md's T11 row state them.  A reflective pixel
(metallic >= 0.01) casts a ray from its view-space position, reflected
about its view-space normal, and marches it: 50 iterations, the first
step 0.5 along the ray, each later marching step 1.05 times the last.
Each iteration projects the ray's point to the screen, takes the depth
there (bilinear, clamp-to-edge) back to view space, and compares |view
z|: delta = |z of the ray| - |z of the surface|.  |delta| < 0.05 is a
hit, and the ray stops there.  While marching, a point behind the
surface (delta > 0) starts the binary refinement, which spends the
iterations that remain: each halves the step and moves the point
against the sign of delta.  A hit's colour is the albedo at its uv
(bilinear); a miss is black; a dielectric pixel (metallic < 0.01) passes
its albedo through and casts no ray.

Departures from the shader, each the port's too:

- the march always runs its 50 iterations as one fixed loop over every
  ray; a ray that has hit is frozen (its point, step and hit uv no
  longer change), which gives the shader's early return;
- the shader's albedo fallback for a miss (``:184-186``) is dead code
  there (alpha is written 1.0 at ``:183``), so a miss is black;
- the shader's HiZ inputs (``:17-18``) are declared and never read, so
  the march reads the full-resolution depth alone;
- float32 throughout, the arithmetic in the order written below (the
  shader's ``reflect``, ``normalize`` and matrix products expanded).

Plain PyTorch: no compaction, no cap and no sort; it imports nothing of
the program.  :func:`ssr` also counts the work a march that stops at its
hit must do (the roofline's ``ssr_march`` job).
"""
from __future__ import annotations

import torch

from . import sampling
from .composition import view_from_depth
from .vec import dot3, mat_vec3, normalize3

RAY_STEP = 0.5           # screen_space_reflection.inl:97-107
ITERATIONS = 50
STEP_GROWTH = 1.05
DISTANCE_BIAS = 0.05
METALLIC_MIN = 0.01      # the early-out, inl:175-178


def _probe(p, depth, projection, inv_projection):
    """(uv (2, ...), delta (...)) of ray points p (3, ...): the point
    projected to the screen, the depth there back in view space, and
    |z of the point| - |z of the surface|."""
    m = projection
    x = m[0, 0] * p[0] + m[0, 1] * p[1] + m[0, 2] * p[2] + m[0, 3]
    y = m[1, 0] * p[0] + m[1, 1] * p[1] + m[1, 2] * p[2] + m[1, 3]
    w = m[3, 0] * p[0] + m[3, 1] * p[1] + m[3, 2] * p[2] + m[3, 3]
    w = torch.where(w != 0, w, 1.0)
    uv = torch.stack([x / w * 0.5 + 0.5, y / w * 0.5 + 0.5])
    surface = view_from_depth(uv, sampling.sample_screen(depth, uv),
                              inv_projection)[2]
    return uv, torch.abs(p[2]) - torch.abs(surface)


def march(pos, normal, depth, projection, inv_projection):
    """The 50-iteration march of rays from view-space points pos (3, N)
    with view-space normals normal (3, N) over the (H, W) depth.
    Returns (found (N,) bool, hit uv (2, N), probes (N,) int64: the
    iterations up to and including the hit, or 50 for a miss)."""
    ray = normalize3(pos - 2.0 * dot3(pos, normal)[None] * normal)
    step = ray * RAY_STEP
    point = pos + step
    live = torch.ones(pos.shape[1:], dtype=torch.bool, device=pos.device)
    refining = torch.zeros_like(live)
    hit_uv = torch.zeros((2,) + pos.shape[1:], dtype=torch.float32,
                         device=pos.device)
    probes = torch.zeros(pos.shape[1:], dtype=torch.int64,
                         device=pos.device)
    for _ in range(ITERATIONS):
        uv, delta = _probe(point, depth, projection, inv_projection)
        probes += live
        hit = live & (torch.abs(delta) < DISTANCE_BIAS)
        hit_uv = torch.where(hit[None], uv, hit_uv)
        live = live & ~hit
        refining = refining | (live & (delta > 0))
        s = torch.sign(delta)[None]
        halved = step * 0.5
        # marching: one step forward (delta < 0 at every marching ray
        # that did not hit), then the next step 1.05 times longer;
        # refining: half the step, against the sign of delta
        point = torch.where(live[None], torch.where(
            refining[None], point - halved * s, point - step * s), point)
        step = torch.where(live[None], torch.where(
            refining[None], halved, step * STEP_GROWTH), step)
    return ~live, hit_uv, probes


def ssr(depth, albedo, normal, metallic_roughness, g):
    """One view's reflections.  depth (H, W); albedo, normal (3, H, W);
    metallic_roughness (2, H, W) (R roughness, G metallic); g the frame's
    globals (the camera's projection, its inverse and the view matrix).

    Returns (image (3, H, W), counts): the counts are ``pixels`` (H·W),
    ``rays`` (the reflective pixels, each one ray) and ``probes`` (summed
    over the rays, the iterations up to and including the hit, or 50 for
    a miss)."""
    H, W = depth.shape
    cam = g.camera
    pos = view_from_depth(sampling.grid_uv(H, W, depth.device), depth,
                          cam.inv_projection)
    view_normal = normalize3(mat_vec3(cam.view[:3, :3], normal))
    reflective = ~(metallic_roughness[1] < METALLIC_MIN)
    found = torch.zeros((H, W), dtype=torch.bool, device=depth.device)
    hit_uv = torch.zeros((2, H, W), dtype=torch.float32, device=depth.device)
    rays = int(reflective.sum())
    probes = 0
    if rays:
        f, uv, n = march(pos[:, reflective], view_normal[:, reflective],
                         depth, cam.projection, cam.inv_projection)
        found[reflective] = f
        hit_uv[:, reflective] = uv
        probes = int(n.sum())
    colour = torch.where(found[None], sampling.sample_screen(albedo, hit_uv),
                         0.0)
    image = torch.where(reflective[None], colour, albedo)
    return image, dict(pixels=H * W, rays=rays, probes=probes)
