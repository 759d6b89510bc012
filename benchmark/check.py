"""What decides ``correct``: the timed path's frames against the reference.

Each sampled frame of the window is rendered again by the plain
reference (:mod:`benchmark.reference`) from the scene's data, its own
globals and the history that the program's previous frame left, and
every target of the frame is compared.  A number is the worst over the
sampled frames:

- ``globals``: the frame's ShaderGlobals against the reference's, max
  abs over every leaf;
- ``tri_id``: the share of pixels whose nearest triangle differs
  between the program's raster and the reference's;
- ``depth`` (on the pixels whose triangle agrees), ``gbuffer`` (albedo,
  normal, metallic-roughness, velocity, emissive), ``bloom``, ``ssao``,
  ``sky_lut``, ``clouds``, ``hdr``, ``exposure``, ``history`` (the bf16
  colour and velocity carried to the next frame), ``color``
  (tonemapped): max over the elements of ``|program - reference| / (1 +
  |reference|)``.

The passes after the raster are held on the program's visibility buffer
(the reference shades the program's depth and triangle ids, as it takes
the program's history), so a pixel where the two rasters pick another
triangle counts once, in ``tri_id``, and every later pass is held to
its own arithmetic.

A configuration's ``check.limits`` names the numbers its cells compare,
each with its limit (``terrain_1080p`` leaves out ``bloom``: the scene
has no emissive texel, so both sides read 0 whatever the code does).
"""
from __future__ import annotations

import dataclasses

import torch

FLOAT_TARGETS = {
    "depth": ("depth",),
    "gbuffer": ("albedo", "normal", "metallic_roughness", "velocity",
                "emissive"),
    "bloom": ("bloom",),
    "ssao": ("ssao",),
    "sky_lut": ("sky_lut",),
    "clouds": ("clouds",),
    "hdr": ("hdr",),
    "exposure": ("exposure",),
    "history": ("history_color", "history_velocity"),
    "color": ("color",),
}
NUMBERS = ("globals", "tri_id") + tuple(FLOAT_TARGETS)


def _rel(a, b) -> float:
    a, b = a.float(), b.float().to(a.device)
    if a.shape != b.shape:
        return float("inf")
    d = (a - b).abs() / (1.0 + b.abs())
    # NaN on both sides agrees; on one side it is a difference
    d = torch.where(torch.isnan(a) & torch.isnan(b), 0.0,
                    torch.nan_to_num(d, nan=float("inf")))
    return float(d.max()) if d.numel() else 0.0


def _leaves(tree, prefix=""):
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), prefix + f.name + ".")
    else:
        yield prefix[:-1], tree


def globals_gap(program_g, reference_g) -> float:
    """Max abs difference over the leaves of two ShaderGlobals trees of
    the same field names (inf where a field is missing or misshapen)."""
    ref = dict(_leaves(reference_g))
    worst = 0.0
    for name, x in _leaves(program_g):
        if name not in ref:
            continue
        y = ref.pop(name).to(x.device)
        if x.shape != y.shape:
            return float("inf")
        d = float((x.double() - y.double()).abs().max()) if x.numel() else 0.0
        worst = max(worst, d if d == d else float("inf"))
    return float("inf") if ref else worst


def compare(program: dict, reference: dict) -> dict:
    """{number: value} of one frame; `program` and `reference` hold the
    targets by the names of FLOAT_TARGETS, ``tri_id`` and ``globals``
    (``globals``: the gap, computed by the caller)."""
    out = {"globals": program["globals"]}
    p, r = program["tri_id"], reference["tri_id"].to(program["tri_id"].device)
    if p.shape != r.shape:
        return dict(out, **{k: float("inf") for k in NUMBERS[1:]})
    agree = p == r
    out["tri_id"] = float((~agree).float().mean())
    out["depth"] = _rel(program["depth"][agree], reference["depth"][agree])
    for number, names in FLOAT_TARGETS.items():
        if number == "depth":
            continue
        have = [n for n in names if n in reference]
        if not have:
            continue
        out[number] = max((_rel(program[n], reference[n])
                           if program.get(n) is not None else float("inf"))
                          for n in have)
    return out


def worst(per_frame: list) -> dict:
    keys = {k for f in per_frame for k in f}
    return {k: max(f.get(k, 0.0) for f in per_frame) for k in sorted(
        keys, key=lambda k: NUMBERS.index(k) if k in NUMBERS else 99)}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number that `limits` names within its limit, {number:
    {"value", "limit"}} of those).  The configuration's limits say which
    numbers its cells compare; one it names that was not read fails."""
    shown = {k: {"value": numbers.get(k, float("inf")), "limit": lim}
             for k, lim in limits.items()}
    ok = bool(shown) and all(c["value"] <= c["limit"]
                             for c in shown.values())
    return ok, shown
