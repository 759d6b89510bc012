"""Image sampling ops in planar layout (components on leading axes).

Counterpart of the JAX package's ``ops/sampling.py``: clamp-to-edge
bilinear sampling with the fraction taken against the CLIPPED base
texel and clamped to [0, 1] (``sampling.py:86-102``), integer shifts,
2x2 pooling and separable bilinear upsampling.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _constant(values, device):
    return torch.tensor(values, dtype=torch.float32, device=device)


def _frozen(v):
    return (tuple(_frozen(x) for x in v) if isinstance(v, (list, tuple))
            else float(v))


def constant(v, device):
    """The f32 constant `v` (a number or a, possibly nested, sequence of
    numbers) on `device`, made once per (values, device) and reused:
    building a tensor from host values is a blocking copy that waits for
    the card's queue, and a frame needs dozens of them.  The tensors are
    shared, so no caller writes them in place."""
    return _constant(_frozen(v), torch.device(device))


def div(x, n):
    """x / n, rounded as a true division on every device (PyTorch's CUDA
    kernel multiplies by the reciprocal of a Python-scalar divisor,
    which differs in the last bit)."""
    return x / torch.full((), n, dtype=x.dtype, device=x.device)


def mod(x, m):
    """jnp.mod for m > 0 (scalar or tensor): the truncated remainder
    moved into [0, m), rounded as JAX rounds it."""
    r = torch.fmod(x, m)
    return torch.where(r < 0, r + m, r)


def grid_uv(h, w, device="cpu", row0: int = 0, full_h: int | None = None):
    """(2, h, w) pixel-centre uv in [0,1].  A row band: the h rows from
    screen row `row0` of a `full_h`-row screen, at their screen uv (each
    value the whole screen's, bit for bit)."""
    ux = div(torch.arange(w, dtype=torch.float32, device=device) + 0.5, w)
    uy = div(torch.arange(row0, row0 + h, dtype=torch.float32,
                          device=device) + 0.5, full_h or h)
    return torch.stack([ux[None, :].expand(h, w), uy[:, None].expand(h, w)])


def shift(img, dx: int, dy: int):
    """Clamp-to-edge integer shift of (..., H, W): out(y, x) =
    img(clamp(y + dy), clamp(x + dx))."""
    H, W = img.shape[-2:]
    xs = torch.clamp(torch.arange(W, device=img.device) + dx, 0, W - 1)
    ys = torch.clamp(torch.arange(H, device=img.device) + dy, 0, H - 1)
    return img[..., ys[:, None], xs[None, :]]


def index_of(v, n: int):
    """float -> int32 the way XLA converts (NaN -> 0, saturating), then
    clamped to [0, n - 1]."""
    v = torch.clamp(torch.nan_to_num(v, nan=-1.0), -1.0, float(n))
    return torch.clamp(v.to(torch.int32), 0, n - 1)


def _lerp2(c00, c10, c01, c11, fx, fy):
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def sample_screen(img, uv, texel_coords: bool = False,
                  method: str = "linear", views: bool = False,
                  row0: int = 0, full_h: int | None = None):
    """Bilinear (method="nearest": nearest-texel) sample of a planar
    image at planar uv, clamp-to-edge.

    img: (C, H, W) or (H, W); uv: (2, ...).  Returns (C, ...) / (...).
    texel_coords: uv already holds the texel coordinates (x, y) that
    u*W - 0.5, v*H - 0.5 would give (the shadow-map crop taps, whose
    full-map coordinates are shifted by the integer crop origin).
    views: img carries a leading view axis, (B, C, H, W) or (B, H, W),
    and uv is (2, B, ...): view b's points tap view b's image.  Returns
    (C, B, ...) / (B, ...).
    row0 / full_h: img holds rows [row0, row0 + H) of a `full_h`-row
    image; the taps are the whole image's (coordinates, clamps and
    weights), read from those rows, which must hold every row tapped."""
    squeeze = img.dim() == (3 if views else 2)
    if squeeze:
        img = img.unsqueeze(-3)
    base = 0
    if views:
        B, C, H, W = img.shape
        flat = img.transpose(0, 1).reshape(C, B * H * W)
        base = (torch.arange(B, device=img.device) * (H * W)).reshape(
            (B,) + (1,) * (uv.dim() - 2))
    else:
        C, H, W = img.shape
        flat = img.reshape(C, H * W)
    Hf = full_h or H
    if texel_coords:
        x, y = uv[0], uv[1]
    else:
        x = uv[0] * W - 0.5
        y = uv[1] * Hf - 0.5
    if method == "nearest":
        xi = index_of(torch.round(x), W)
        yi = index_of(torch.round(y), Hf) - row0
        out = flat[:, (yi * W + xi).long() + base]
        return out[0] if squeeze else out
    x0i = index_of(torch.floor(x), W)
    y0i = index_of(torch.floor(y), Hf)
    x1i = torch.clamp(x0i + 1, max=W - 1)
    y1i = torch.clamp(y0i + 1, max=Hf - 1)
    fx = torch.clamp(x - x0i, 0.0, 1.0)
    fy = torch.clamp(y - y0i, 0.0, 1.0)
    r0 = ((y0i - row0) * W).long() + base
    r1 = ((y1i - row0) * W).long() + base
    out = _lerp2(flat[:, r0 + x0i], flat[:, r0 + x1i],
                 flat[:, r1 + x0i], flat[:, r1 + x1i], fx, fy)
    return out[0] if squeeze else out


def sample_screen_separable(img, u, v):
    """Bilinear clamp-to-edge sample of (..., H, W) at the outer product
    of 1-D u (length W') and 1-D v (length H'); same result as
    sample_screen on the meshgrid (x lerp first, then y).  Returns
    (..., H', W')."""
    H, W = img.shape[-2:]
    x = u * W - 0.5
    y = v * H - 0.5
    x0i = index_of(torch.floor(x), W)
    y0i = index_of(torch.floor(y), H)
    x1i = torch.clamp(x0i + 1, max=W - 1)
    y1i = torch.clamp(y0i + 1, max=H - 1)
    fx = torch.clamp(x - x0i, 0.0, 1.0)
    fy = torch.clamp(y - y0i, 0.0, 1.0)[:, None]
    ax = (img[..., x0i.long()] * (1 - fx)
          + img[..., x1i.long()] * fx)                     # (..., H, W')
    return ax[..., y0i.long(), :] * (1 - fy) + ax[..., y1i.long(), :] * fy


def upsample_bilinear(img, oh, ow, rows=None, src_row0: int = 0,
                      src_h: int | None = None):
    """(..., h, w) -> (..., oh, ow) separable bilinear, clamp-to-edge.

    A row band: img holds rows [src_row0, src_row0 + h) of an `src_h`-row
    source (rows past the source's edges, if any, repeat its edge rows),
    and the output is rows [rows[0], rows[1]) of the (oh, ow) upsample,
    each the whole upsample's, bit for bit; img must hold every source
    row those rows read."""
    H, W = img.shape[-2:]
    Hs = src_h or H
    dev = img.device
    a, b = rows if rows is not None else (0, oh)
    ys = (torch.arange(a, b, dtype=torch.float32, device=dev) + 0.5) * Hs \
        / oh - 0.5
    xs = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) * W / ow \
        - 0.5
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, Hs - 1)
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, W - 1)
    y1 = torch.clamp(y0 + 1, 0, Hs - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    fy = torch.clamp(ys - y0, 0.0, 1.0)[:, None]
    fx = torch.clamp(xs - x0, 0.0, 1.0)
    r0 = img[..., y0 - src_row0, :]
    r1 = img[..., y1 - src_row0, :]
    a = r0[..., x0] * (1 - fx) + r0[..., x1] * fx
    b = r1[..., x0] * (1 - fx) + r1[..., x1] * fx
    return a * (1 - fy) + b * fy


def edge_pad(img, lo_y, hi_y, lo_x, hi_x):
    """Edge-replicating pad of the last two axes of (..., H, W)."""
    H, W = img.shape[-2:]
    out = F.pad(img.reshape(1, -1, H, W), (lo_x, hi_x, lo_y, hi_y),
                mode="replicate")
    return out.reshape(*img.shape[:-2], *out.shape[-2:])


def sample_shadow_cmp(shadow, uv, ref, border: float = 1.0,
                      views: bool = False):
    """Comparison-sampler shadow fetch (renderer.cpp:54-69).

    shadow: (S, S) depth; uv: (2, ...); ref: (...).  Returns (...) in
    [0, 1]: the bilinear blend of the four texels' (ref < depth) tests;
    texels outside the map read the opaque-white border.  views: shadow
    is (B, S, S), uv (2, B, ...) and ref (B, ...): view b's points test
    view b's map."""
    S = shadow.shape[-1]
    base = 0
    if views:
        base = (torch.arange(shadow.shape[0], device=shadow.device)
                * (S * S)).reshape((-1,) + (1,) * (uv.dim() - 2))
    x = uv[0] * S - 0.5
    y = uv[1] * S - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    flat = shadow.reshape(-1)

    def texel(v):
        # NaN -> 0 and saturation far outside the map, as XLA converts:
        # past [-2, S + 1] all four texels are border either way
        return torch.clamp(torch.nan_to_num(v, nan=0.0), -2.0,
                           S + 1.0).to(torch.int32)

    x0i, y0i = texel(x0), texel(y0)

    def fetch(xi, yi):
        inside = (xi >= 0) & (xi < S) & (yi >= 0) & (yi < S)
        idx = torch.clamp(yi, 0, S - 1) * S + torch.clamp(xi, 0, S - 1)
        d = torch.where(inside, flat[idx.long() + base], border)
        return (ref < d).to(torch.float32)

    t00 = fetch(x0i, y0i)
    t10 = fetch(x0i + 1, y0i)
    t01 = fetch(x0i, y0i + 1)
    t11 = fetch(x0i + 1, y0i + 1)
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy
