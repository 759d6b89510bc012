"""Clouds + single-scattering atmosphere through the sky LUT.

Counterpart of the JAX package's ``ops/clouds.py`` on its LUT path:
``render_sky_lut`` (a 256x128 lat-long direction LUT: 16x8-step
atmosphere, 24-step cloud march with a 10-step sun march, 4-octave fBm,
two-lobe HG, powder/Beer, scatter integral), over the (64, 64) tiled
noise texture when given one (the plain version of kernel K6,
``ops/sky.py``) or procedural value noise without it, and
``sky_from_lut`` (the per-pixel bayer16-dithered lookup with the
reference's QUADRANT quirk).  This file is the benchmark's frozen copy
of the port's module without its per-pixel march (``render_clouds``,
off by default).

Vectors ride the LAST axis as in the JAX version.  With batched
ShaderGlobals (a leading view axis, ``parallel/mesh.py``) the LUT and
its lookup are made for every view at once: a per-view vector is
shaped (B, 1, 1, 3) against the (lut_h, lut_w, 3) rays, the LUTs come
out (B, 3, lut_h, lut_w); the per-pixel march takes the views' rows as
more rows, each with its view's values.  The march's steps
are independent except for the transmittance carry, so the 24 primary
samples and their 24x10 sun-march samples are evaluated as one batch;
every point gets the same operations in the same order as the JAX
loop, and the sums over steps are taken in loop order.
"""
from __future__ import annotations

import math

import torch

from . import sampling
from . import views

CLOUD_SPEED = 0.02
CLOUD_HEIGHT = 1600.0
CLOUD_THICKNESS = 500.0
CLOUD_DENSITY = 0.03
EARTH_RADIUS = 6371000.0
SUN_BRIGHTNESS = 3.0
CLOUD_MIN = CLOUD_HEIGHT
CLOUD_MAX = CLOUD_HEIGHT + CLOUD_THICKNESS
RAYLEIGH = (0.27e-5, 0.5e-5, 1.0e-5)
MIE = (0.5e-6, 0.5e-6, 0.5e-6)
R_LOG2 = float(1.0 / math.log(2.0))
LN2 = math.log(2.0)


# each f32 constant once per (values, device): see sampling.constant
_vec = sampling.constant


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _norm(a):
    return torch.sqrt(_dot(a, a))


def _bayer2(ax, ay):
    ax = torch.floor(ax)
    ay = torch.floor(ay)
    return sampling.mod(ax * 0.5 + ay * ay * 0.75, 1.0)


def bayer16(ax, ay):
    """cloud_rendering.inl:92-113 macro expansion (the macros add
    bayer2(a), not bayer4/8(a) — kept verbatim).  ax, ay: pixel x, y."""
    def b4(x, y):
        return _bayer2(x * 0.5, y * 0.5) * 0.25 + _bayer2(x, y)

    def b8(x, y):
        return b4(x * 0.5, y * 0.5) * 0.25 + _bayer2(x, y)

    return b8(ax * 0.5, ay * 0.5) * 0.25 + _bayer2(ax, ay)


def _rsi(position, direction, radius):
    """Ray-sphere intersection (:97-106); returns (near, far), -1 on miss."""
    pod = _dot(position, direction)
    delta = pod * pod + radius * radius - _dot(position, position)
    ok = delta >= 0
    sq = torch.sqrt(torch.clamp(delta, min=0.0))
    near = -pod - sq
    far = -pod + sq
    return torch.where(ok, near, -1.0), torch.where(ok, far, -1.0)


def _particle_thickness(depth):
    depth = depth * 2.0
    depth = torch.clamp(depth + 0.01, min=0.01)
    return 100000.0 / depth


def _absorb(coeff, depth):
    return torch.exp(coeff * (-depth))


def _hg(x, g):
    g2 = g * g
    return 0.25 * (1.0 - g2) * (1.0 + g2 - 2.0 * g * x) ** -1.5


def _phase_two_lobes(x):
    m, gm = 0.5, 0.8
    lobe1 = _hg(x, 0.8 * gm)
    lobe2 = _hg(x, -0.5 * gm)
    return lobe2 + (lobe1 - lobe2) * m


def _powder(od):
    return 1.0 - torch.exp(-od * 2.0)


def _scatter_integral(od, coeff=1.11):
    a = -coeff * R_LOG2
    return torch.exp(a * od) * (-1.0 / coeff) + 1.0 / coeff


def _d02(x):
    return torch.abs(x) + 1e-3


def _atmospheric_scattering_top(sun_dir):
    """:196-218 — constant per frame (sky light for cloud shading)."""
    dev = sun_dir.device
    total = _vec(RAYLEIGH, dev) + _vec(MIE, dev)
    od = 100000.0 / _vec(max(1.0 * 2.0 - 0.01, 0.01), dev)
    odl = _particle_thickness(sun_dir[..., 1:2])
    scatter_view = total * od
    absorb_view = _absorb(total, od)
    scatter_light = total * odl
    absorb_light = _absorb(total, odl)
    absorb_sun = _d02(absorb_light - absorb_view) / _d02(
        (scatter_light - scatter_view) * LN2)
    scatter_sun = _vec(MIE, dev) * od * 0.25 + _vec(RAYLEIGH, dev) * od * 0.375
    return scatter_sun * absorb_sun * SUN_BRIGHTNESS


def _hash2(x, y):
    """Procedural 2D value hash (the SSAO shader's rand())."""
    return sampling.mod(torch.sin(x * 12.9898 + y * 78.233) * 43758.5453,
                        1.0)


def _value_noise2(u, v):
    """Bilinear value noise over the integer lattice."""
    iu = torch.floor(u)
    iv = torch.floor(v)
    fu = u - iu
    fv = v - iv
    fu = fu * fu * (3.0 - 2.0 * fu)
    fv = fv * fv * (3.0 - 2.0 * fv)
    a = _hash2(iu, iv)
    b = _hash2(iu + 1.0, iv)
    c = _hash2(iu, iv + 1.0)
    d = _hash2(iu + 1.0, iv + 1.0)
    return (a + (b - a) * fu) * (1 - fv) + (c + (d - c) * fu) * fv


def _sample_repeat(tex, u, v):
    """Bilinear repeat sampling of an (N, N) float texture at (u, v)."""
    N = tex.shape[-1]
    x = u * N - 0.5
    y = v * N - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = torch.remainder(x0.to(torch.int32), N)
    x1i = torch.remainder(x0i + 1, N)
    y0i = torch.remainder(y0.to(torch.int32), N)
    y1i = torch.remainder(y0i + 1, N)
    flat = tex.reshape(-1)
    r0 = (y0i * N).long()
    r1 = (y1i * N).long()
    c00 = flat[r0 + x0i]
    c10 = flat[r0 + x1i]
    c01 = flat[r1 + x0i]
    c11 = flat[r1 + x1i]
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)


def _get_3d_noise(pos, noise_tex=None):
    """:219-233: fake 3D from a tiled 2D noise field with z-slice
    interpolation; noise_tex=None replaces noise.png with procedural
    value noise."""
    p = torch.floor(pos[..., 2])
    f = pos[..., 2] - p
    inv_res = 1.0 / 64.0
    z_stretch = 17.0 * inv_res
    cu = pos[..., 0] * inv_res + p * z_stretch
    cv = pos[..., 1] * inv_res + p * z_stretch
    if noise_tex is None:
        n0 = _value_noise2(cu * 64.0, cv * 64.0)
        n1 = _value_noise2((cu + z_stretch) * 64.0, (cv + z_stretch) * 64.0)
    else:
        n0 = _sample_repeat(noise_tex, cu, cv)
        n1 = _sample_repeat(noise_tex, cu + z_stretch, cv + z_stretch)
    return n0 + (n1 - n0) * f


def _get_clouds(p, camera_pos, elapsed_time, noise_tex=None):
    """:235-262."""
    up = _vec([0.0, EARTH_RADIUS, 0.0], p.device)
    py = _norm(p + up) - EARTH_RADIUS
    pxz = p[..., ::2] + camera_pos[..., ::2]
    inside = (py >= CLOUD_MIN) & (py <= CLOUD_MAX)

    time = -CLOUD_SPEED * elapsed_time
    mv = torch.stack([time, torch.zeros_like(time), time], -1)
    # py is shared by the views where p is (the LUT's rays), pxz not
    coord = torch.stack(torch.broadcast_tensors(pxz[..., 0], py,
                                                pxz[..., 1]), -1) * 0.001 + mv

    noise = _get_3d_noise(coord, noise_tex) * 0.5
    noise = noise + _get_3d_noise(coord * 2.0 + mv, noise_tex) * 0.25
    noise = noise + _get_3d_noise(coord * 7.0 - mv, noise_tex) * 0.125
    noise = noise + _get_3d_noise((coord + mv) * 16.0, noise_tex) * 0.0625

    hh = py - CLOUD_MIN
    thresh = (1.0 - torch.exp(-0.01 * hh)) * torch.exp(-0.004 * hh)
    t = torch.clamp((noise - 0.55) / 0.05, 0.0, 1.0)
    clouds = (t * t * (3.0 - 2.0 * t)) * thresh
    return torch.where(inside, clouds * CLOUD_DENSITY, 0.0)


def sky_light_term(sun_dir):
    """The clouds' constant sky light, sky_light * 0.25 / pi (:196-218,
    :341), (3,)."""
    return _atmospheric_scattering_top(sun_dir) * 0.25 / math.pi


def _volumetric_clouds(ray_dir, sun_dir, color, dither, sun_color,
                       camera_pos, elapsed_time, noise_tex=None,
                       steps: int = 24, sun_steps: int = 10):
    """:307-350 (with the :264-278 sun-visibility march inlined)."""
    dev = ray_dir.device
    up = _vec([0.0, 1.0, 0.0], dev) * EARTH_RADIUS
    _, bottom = _rsi(up, ray_dir, EARTH_RADIUS + CLOUD_MIN)
    _, top = _rsi(up, ray_dir, EARTH_RADIUS + CLOUD_MAX)
    start = ray_dir * bottom[..., None]
    end = ray_dir * top[..., None]
    inc = (end - start) / steps
    pos = start + inc * dither[..., None]
    step_len = _norm(inc)

    ldotw = _dot(ray_dir, sun_dir)
    phase = _phase_two_lobes(ldotw)

    # all march samples at once: (steps, ...) primary positions and
    # (steps, sun_steps, ...) sun-visibility positions
    ii = torch.arange(steps, dtype=torch.float32, device=dev)
    cpos = pos + inc * ii.reshape(-1, *([1] * inc.dim()))
    r_steps = CLOUD_THICKNESS / sun_steps
    s_inc = sun_dir * r_steps
    jj = torch.arange(sun_steps, dtype=torch.float32, device=dev)
    spos = (cpos + s_inc * 0.5)[:, None] \
        + s_inc * jj.reshape(1, -1, *([1] * (cpos.dim() - 1)))
    od_all = _get_clouds(cpos, camera_pos, elapsed_time,
                         noise_tex) * step_len
    sun_d = _get_clouds(spos, camera_pos, elapsed_time, noise_tex)

    scattering = torch.zeros_like(color)
    trans = torch.ones_like(step_len)
    skylight = sky_light_term(sun_dir)
    for i in range(steps):
        od = od_all[i]
        strans = torch.zeros_like(od)
        for j in range(sun_steps):
            strans = strans + sun_d[i, j]
        sunv = torch.exp(-strans * r_steps)
        integral = _scatter_integral(od)
        beers_powder = _powder(od * LN2)
        sunlight = (sun_color * (sunv * beers_powder * phase)[..., None]
                    * (0.5 * math.pi) * SUN_BRIGHTNESS)
        scat = (sunlight + skylight) * (integral * math.pi)[..., None]
        hit = od > 0.0
        scattering = scattering + torch.where(
            hit[..., None], scat * trans[..., None], 0.0)
        trans = torch.where(hit, trans * torch.exp(-od), trans)

    mixed = color * trans[..., None] + scattering
    fade = torch.clamp(_norm(start) * 0.00001 * 2.5, 0.0, 1.0)
    out = mixed + (color - mixed) * fade[..., None]
    return torch.where((ray_dir[..., 1] < 0.0)[..., None], color, out)


def _atmosphere(ray_dir, origin, sun_dir, elapsed_time,
                i_sun=22.0, r_planet=6371e3, r_atmos=6471e3,
                sh_rlh=8e3, sh_mie=1.2e3, g=0.758,
                i_steps: int = 16, j_steps: int = 8):
    """:355-439 (nvnv's 'atmosphere' with the iTime=elapsed_time quirk);
    the j (light) march of each i step runs as one batch."""
    dev = ray_dir.device
    k_rlh = _vec([5.5e-6, 13.0e-6, 22.4e-6], dev)
    k_mie = 21e-6
    r = ray_dir / torch.clamp(_norm(ray_dir), min=1e-12)[..., None]
    p_near, p_far = _rsi(origin, r, r_atmos)
    miss = p_near > p_far
    g_near, _ = _rsi(origin, r, r_planet)
    p_far = torch.minimum(p_far, g_near)
    i_step = (p_far - p_near) / i_steps

    mu = _dot(r, sun_dir)
    mumu = mu * mu
    gg = g * g
    p_rlh = 3.0 / (16.0 * math.pi) * (1.0 + mumu)
    p_mie = (3.0 / (8.0 * math.pi) * ((1.0 - gg) * (mumu + 1.0))
             / ((1.0 + gg - 2.0 * mu * g) ** 1.5 * (2.0 + gg)))

    i_time = elapsed_time.expand(i_step.shape)      # the :368 quirk
    total_rlh = torch.zeros_like(r)
    total_mie = torch.zeros_like(r)
    i_od_rlh = torch.zeros_like(i_step)
    i_od_mie = torch.zeros_like(i_step)
    jj = torch.arange(j_steps, dtype=torch.float32, device=dev)
    jj = jj.reshape(-1, *([1] * i_step.dim()))

    for _ in range(i_steps):
        i_pos = origin + r * (i_time + i_step * 0.5)[..., None]
        i_h = _norm(i_pos) - r_planet
        od_rlh = torch.exp(-i_h / sh_rlh) * i_step
        od_mie = torch.exp(-i_h / sh_mie) * i_step
        i_od_rlh = i_od_rlh + od_rlh
        i_od_mie = i_od_mie + od_mie

        _, j_far = _rsi(i_pos, sun_dir, r_atmos)
        j_step = j_far / j_steps
        j_time = j_step * jj
        j_pos = i_pos + sun_dir * (j_time + j_step * 0.5)[..., None]
        j_h = _norm(j_pos) - r_planet
        e_rlh = torch.exp(-j_h / sh_rlh) * j_step
        e_mie = torch.exp(-j_h / sh_mie) * j_step
        j_od_rlh = torch.zeros_like(j_step)
        j_od_mie = torch.zeros_like(j_step)
        for j in range(j_steps):
            j_od_rlh = j_od_rlh + e_rlh[j]
            j_od_mie = j_od_mie + e_mie[j]

        attn = torch.exp(-(k_mie * (i_od_mie + j_od_mie)[..., None]
                           + k_rlh * (i_od_rlh + j_od_rlh)[..., None]))
        total_rlh = total_rlh + od_rlh[..., None] * attn
        total_mie = total_mie + od_mie[..., None] * attn
        i_time = i_time + i_step

    out = i_sun * (p_rlh[..., None] * k_rlh * total_rlh
                   + p_mie[..., None] * k_mie * total_mie)
    return torch.where(miss[..., None], 0.0, out)


def sky_horizon(sun_dir):
    """The horizon darkening max(min(|sx|, |sz|) + sy, 0) (:477) of
    sun_dir (..., 3), shaped (..., 1)."""
    return torch.clamp(
        torch.minimum(torch.abs(sun_dir[..., 0:1]),
                      torch.abs(sun_dir[..., 2:3]))
        + sun_dir[..., 1:2], min=0.0)


def _lut_view(x, nv: int, vector: bool):
    """A per-view leaf (*V[, 3]) shaped to broadcast against the LUT's
    (lut_h, lut_w[, 3]) arrays: (*V, 1, 1[, 3])."""
    if not nv:
        return x
    if vector:
        return x.reshape(*x.shape[:-1], 1, 1, x.shape[-1])
    return x.reshape(*x.shape, 1, 1)


def render_sky_lut(g, lut_w: int = 256, lut_h: int = 128, noise_tex=None):
    """March atmosphere + clouds over a lat-long direction LUT.  Returns
    (3, lut_h, lut_w): azimuth in [-pi, pi) across width, elevation in
    [-pi/2, pi/2] across height.  noise_tex: the (64, 64) tiled cloud
    noise (the exact texture branch, K6's plain version); None takes
    procedural value noise.  Batched globals give (B, 3, lut_h, lut_w),
    a LUT per view."""
    dev = g.sun.direction.device
    az = ((torch.arange(lut_w, dtype=torch.float32, device=dev) + 0.5)
          / lut_w * 2.0 * math.pi - math.pi)
    el = ((torch.arange(lut_h, dtype=torch.float32, device=dev) + 0.5)
          / lut_h * math.pi - math.pi / 2)
    ca, sa = torch.cos(az)[None, :], torch.sin(az)[None, :]
    ce, se = torch.cos(el)[:, None], torch.sin(el)[:, None]
    shape = (lut_h, lut_w)
    ray = torch.stack([(ce * ca).expand(shape), se.expand(shape),
                       (ce * sa).expand(shape)], -1)

    nv = g.frame_counter.dim()
    ray = ray.reshape((1,) * nv + ray.shape)      # the rays are shared
    sun_dir = _lut_view(-g.sun.direction, nv, True)
    cam = _lut_view(g.camera.position, nv, True)
    elapsed = _lut_view(g.elapsed_time, nv, False)
    origin = _vec([0.0, 6372e3, 0.0], dev) + cam
    atmos = _atmosphere(ray, origin, sun_dir, elapsed)
    sky = _volumetric_clouds(ray, sun_dir, atmos,
                             torch.full(ray.shape[:-1], 0.5, device=dev),
                             _vec([0.8, 0.8, 0.8], dev),
                             cam, elapsed, noise_tex)
    return (sky * sky_horizon(sun_dir)).movedim(-1, -3)


def _pixel_rays(g, width: int, height: int, fw, fh, dev, rows=None):
    """World-space unit ray of each pixel of a (height, width) target
    whose pixel coordinates are divided by (fw - 1, fh - 1)
    (cloud_rendering.inl:443-455 with its quirks): (px, py, dx, dy, dz),
    the directions (height, width); of its rows [rows[0], rows[1]) alone
    when `rows` is given."""
    a, b = rows if rows is not None else (0, height)
    px = torch.arange(width, dtype=torch.float32, device=dev)
    py = torch.arange(a, b, dtype=torch.float32, device=dev)
    shape = (b - a, width)
    u = (px[None, :] / (fw - 1.0)).expand(shape)
    v = (py[:, None] / (fh - 1.0)).expand(shape)
    ndc_x = u * 2.0 - 1.0
    ndc_y = v * 2.0 - 1.0

    inv_p = g.camera.inv_projection
    vx = (inv_p[0, 0] * ndc_x + inv_p[0, 1] * ndc_y - inv_p[0, 2]
          + 0 * inv_p[0, 3])
    vy = inv_p[1, 0] * ndc_x + inv_p[1, 1] * ndc_y - inv_p[1, 2]
    inv_v = g.camera.inv_view
    wx = inv_v[0, 0] * vx + inv_v[0, 1] * vy - inv_v[0, 2]
    wy = inv_v[1, 0] * vx + inv_v[1, 1] * vy - inv_v[1, 2]
    wz = inv_v[2, 0] * vx + inv_v[2, 1] * vy - inv_v[2, 2]
    n = torch.sqrt(torch.clamp(wx * wx + wy * wy + wz * wz, min=1e-12))
    return px, py, wx / n, wy / n, wz / n


def sky_from_lut(g, lut, depth_full, width: int, height: int,
                 dither: bool = True, full_width: int | None = None,
                 full_height: int | None = None, rows=None):
    """Per-pixel sky via LUT lookup at the pixel's ray direction
    (render_clouds' ray construction, :445-455 quirks, and the QUADRANT
    quirk when full_width/full_height are given).  Returns
    (3, height, width) half-res sky colour; non-sky pixels take the
    (0.2, 0.4, 1.0) clear.  Batched: g, lut (B, 3, lut_h, lut_w) and
    depth_full (B, H, W) give (B, 3, height, width), each view looking
    up its own LUT.  rows: rows [rows[0], rows[1]) of the target alone
    (a row band; each pixel reads the whole screen's depth_full, which
    the QUADRANT quirk taps far from the pixel's own rows)."""
    dev = depth_full.device
    nv = g.frame_counter.dim()
    fw = width if full_width is None else full_width
    fh = height if full_height is None else full_height
    px, py, dx, dy, dz = _pixel_rays(views.planar(g, 2), width, height, fw,
                                     fh, dev, rows)
    shape = (py.shape[0], width)

    az = torch.atan2(dz, dx)
    el = torch.asin(torch.clamp(dy, -1.0, 1.0))
    lu = (az + math.pi) / (2.0 * math.pi)
    lv = (el + math.pi / 2) / math.pi
    lut_h, lut_w = lut.shape[-2], lut.shape[-1]
    if dither:
        d16 = bayer16(px[None, :].expand(shape),
                      py[:, None].expand(shape)) - 0.5
        lu = lu + d16 / lut_w
        lv = lv + d16 / lut_h
    # azimuth wraps: sample a 1-column-padded copy (texel i at i + 1)
    lu = lu - torch.floor(lu)
    lut_p = torch.cat([lut[..., -1:], lut, lut[..., :1]], dim=-1)
    lu_p = (lu * lut_w + 1.0) / (lut_w + 2.0)
    sky = sampling.sample_screen(lut_p, torch.stack([lu_p, lv]),
                                 views=nv > 0)

    d = sampling.sample_screen_separable(depth_full, px / (fw - 1.0),
                                         py / (fh - 1.0))
    base = _vec([0.2, 0.4, 1.0], dev).reshape(3, *(1,) * d.dim())
    return views.from_planar(torch.where((d == 1.0)[None], sky, base), nv)

