"""Row bands of one frame over the devices of a mesh axis, with halos.

Counterpart of the JAX package's ``parallel/halo.py``.  There,
``shard_map`` runs a function per row band of an array sharded over a
mesh axis and ``lax.ppermute`` brings each band its neighbours' halo
rows.  Here one process drives the devices itself: an image split on
rows is a Python list of tensors, band i on the axis's device i (a list
of *bands*), and a halo is a slice of the neighbouring band moved with
``.to(device, non_blocking=True)``; where both bands sit on one device
it is a slice and a ``cat`` with no copy between devices.  Screen-edge
bands replicate their edge row, as ``halo.py:45-56`` does, which
reproduces the clamp-to-edge reads of the whole screen exactly.

Bands need not be equal: a band list's row starts are the running sum
of its bands' heights (:func:`starts_of`); :func:`band_starts` cuts a
screen into even-height bands for the half-resolution passes.
Replicated inputs (the scene's batch, records, the per-frame globals)
are held once per *distinct* device (:func:`replicate`): four bands on
one card share one copy.
"""
from __future__ import annotations

import dataclasses

import torch


def distinct(devices) -> list:
    """The distinct devices of `devices`, in their first order."""
    out = []
    for d in devices:
        if d not in out:
            out.append(d)
    return out


def band_starts(height: int, n: int) -> list:
    """Row starts (n + 1 entries, the last `height`) of n bands of even
    height covering `height` rows, as equal as the even heights allow
    (the half-resolution passes halve each band).  Raises where the rows
    cannot be cut so: an odd height, or fewer row pairs than bands."""
    if height % 2 or height // 2 < n:
        raise ValueError(f"{height} rows do not cut into {n} bands of even "
                         f"height")
    pairs, extra = divmod(height // 2, n)
    starts = [0]
    for i in range(n):
        starts.append(starts[-1] + 2 * (pairs + (i < extra)))
    return starts


def starts_of(bands) -> list:
    """Row starts of a band list: [0, h0, h0 + h1, ..., H]."""
    starts = [0]
    for b in bands:
        starts.append(starts[-1] + b.shape[-2])
    return starts


def split_rows(x, devices, starts=None) -> list:
    """A whole (..., H, W) image -> its bands on `devices` (row starts
    `starts`, default band_starts(H, len(devices)))."""
    if starts is None:
        starts = band_starts(x.shape[-2], len(devices))
    return [x[..., a:b, :].to(d, non_blocking=True)
            for a, b, d in zip(starts, starts[1:], devices)]


def rows_of(bands, a: int, b: int, device):
    """Rows [a, b) of the image held as `bands`, on `device`; rows above
    the screen repeat its first row and rows below it its last (the
    clamp-to-edge of the whole screen).  One band's own rows on its own
    device come back as a view."""
    starts = starts_of(bands)
    H = starts[-1]
    parts = []
    if a < 0:
        first = next(x for x in bands if x.shape[-2])
        parts.append(first[..., :1, :].expand(
            *first.shape[:-2], min(-a, b - a), first.shape[-1]))
    lo, hi = max(a, 0), min(b, H)
    for x, s, e in zip(bands, starts, starts[1:]):
        if max(lo, s) < min(hi, e):
            parts.append(x[..., max(lo, s) - s:min(hi, e) - s, :])
    if b > H:
        last = next(x for x in reversed(bands) if x.shape[-2])
        parts.append(last[..., -1:, :].expand(
            *last.shape[:-2], min(b - H, b - a), last.shape[-1]))
    parts = [p.to(device, non_blocking=True) for p in parts]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)


def exchange_row_halos(bands, halo_top: int, halo_bot: int) -> list:
    """Bands (..., h_i, W) -> (..., halo_top + h_i + halo_bot, W): each
    band with its neighbours' rows above and below, on its own device;
    the screen's edge bands repeat their edge row."""
    starts = starts_of(bands)
    return [rows_of(bands, s - halo_top, e + halo_bot, x.device)
            for x, s, e in zip(bands, starts, starts[1:])]


def assemble(bands, device):
    """The whole image of `bands` on `device` (for comparisons and the
    passes that read the whole screen)."""
    return rows_of(bands, 0, starts_of(bands)[-1], device)


def gather(bands) -> dict:
    """{device: the whole image} for each distinct device of `bands`:
    assembled once on the first, copied to the others."""
    devs = distinct(x.device for x in bands)
    whole = assemble(bands, devs[0])
    return {d: whole.to(d, non_blocking=True) for d in devs}


def move(obj, device):
    """A tensor, or a dataclass / tuple tree of tensors, on `device`
    (leaves already there are not copied)."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device, non_blocking=True)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: move(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)})
    if isinstance(obj, (tuple, list)):
        return type(obj)(move(x, device) for x in obj)
    return obj


def replicate(obj, devices) -> dict:
    """{device: obj on device} for each distinct device of `devices`: a
    tensor, or a dataclass / tuple tree of tensors (ShaderGlobals, a
    SceneBatch).  A dict is taken as replicas already."""
    if isinstance(obj, dict):
        return obj
    return {d: move(obj, d) for d in distinct(devices)}


def row_band_call(mesh, axis: str, fn, imgs, rep_args=(), *,
                  halo_top: int = 0, halo_bot: int = 0, full_h=None):
    """Run `fn` per row band of the devices of mesh axis `axis`, with
    halo rows (the JAX ``row_band_call``).

    imgs: a tuple of images, each a band list or a whole (..., H, W)
    tensor (split by band_starts(full_h or H, n)); every image has the
    same row starts.  rep_args: a tuple of replicated arguments (see
    :func:`replicate`).  fn(padded, row0, *rep) gets the band's images
    with halo_top rows above and halo_bot below (edge bands repeat their
    edge row) and the screen row of its first padded row, `row0`, which
    is negative on band 0 when halo_top > 0; it returns a tensor or a
    tuple of tensors with the padded band's rows.  The halos are cropped
    off the outputs, which come back as band lists (one per output),
    each band on its device."""
    devices = mesh.band_devices(axis)
    bands = []
    for img in imgs:
        if isinstance(img, torch.Tensor):
            img = split_rows(img, devices, band_starts(
                full_h or img.shape[-2], len(devices)))
        if len(img) != len(devices):
            raise ValueError(f"{len(img)} bands for {len(devices)} devices")
        bands.append(img)
    starts = starts_of(bands[0])
    if any(starts_of(b) != starts for b in bands):
        raise ValueError("the images' bands differ in rows")
    reps = [replicate(r, devices) for r in rep_args]
    outs = []
    for i, dev in enumerate(devices):
        padded = tuple(rows_of(b, starts[i] - halo_top,
                               starts[i + 1] + halo_bot, dev) for b in bands)
        out = fn(padded, starts[i] - halo_top, *(r[dev] for r in reps))
        single = isinstance(out, torch.Tensor)
        outs.append([o[..., halo_top:o.shape[-2] - halo_bot, :]
                     for o in ((out,) if single else out)])
    per_output = [list(x) for x in zip(*outs)]
    return per_output[0] if single else tuple(per_output)
