"""GUI property-widget schema layer.

Counterpart of the JAX package's ``ui/widgets.py``, the analog of the
reference's ImGui helper library (``src/ui/ui.{hpp,cpp}``:
string/u64/i32/f32/vec2/vec3 property rows with reset buttons and
tooltips).  Widgets are declarative JSON schemas that the web viewer
(:mod:`.server`) renders and round-trips; tensor values are read back
to the host.
"""
from __future__ import annotations

import numpy as np


def _v(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    a = np.asarray(x)
    return a.tolist() if a.ndim else float(a)


def string_property(name, value, tooltip=None):
    return {"kind": "string", "name": name, "value": str(value),
            "tooltip": tooltip}


def u64_property(name, value, tooltip=None):
    return {"kind": "u64", "name": name, "value": int(value),
            "tooltip": tooltip}


def i32_property(name, value, lo=None, hi=None, reset=None, tooltip=None):
    return {"kind": "i32", "name": name, "value": int(value), "min": lo,
            "max": hi, "reset": reset, "tooltip": tooltip}


def f32_property(name, value, lo=None, hi=None, reset=None, tooltip=None):
    return {"kind": "f32", "name": name, "value": _v(value), "min": lo,
            "max": hi, "reset": reset, "tooltip": tooltip}


def vec2_property(name, value, reset=None, tooltip=None):
    return {"kind": "vec2", "name": name, "value": _v(value),
            "reset": reset, "tooltip": tooltip}


def vec3_property(name, value, reset=None, tooltip=None):
    return {"kind": "vec3", "name": name, "value": _v(value),
            "reset": reset, "tooltip": tooltip}


def color3_property(name, value, tooltip=None):
    return {"kind": "color3", "name": name, "value": _v(value),
            "tooltip": tooltip}


def settings_schema(globals_obj):
    """The renderer settings panel (renderer.cpp:683-767): every
    live-tunable ShaderGlobals parameter, grouped like the reference's
    collapsible sections."""
    g = globals_obj
    return {
        "terrain settings": [
            vec2_property("scale", g.terrain_scale),
            f32_property("height scale", g.terrain_height_scale),
            f32_property("midpoint", g.terrain_midpoint),
            f32_property("delta", g.terrain_delta),
            f32_property("min depth", g.terrain_min_depth),
            f32_property("max depth", g.terrain_max_depth),
        ],
        "sun settings": [
            vec3_property("position", g.sun.position),
            f32_property("exponential factor", g.sun.exponential_factor),
            f32_property("darkening factor", g.sun.darkening_factor),
            f32_property("bias", g.sun.bias),
            f32_property("intensity", g.sun.intensity),
        ],
        "ssao settings": [
            f32_property("bias", g.ssao_bias),
            f32_property("radius", g.ssao_radius),
        ],
        "composition settings": [
            vec3_property("ambient", g.ambient),
            f32_property("ambient occlusion strength",
                         g.ambient_occlussion_strength),
            f32_property("emissive bloom strength",
                         g.emissive_bloom_strength),
        ],
        "depth of field settings": [
            f32_property("focal length", g.focal_length),
            f32_property("plane in focus", g.plane_in_focus),
            f32_property("aperture", g.aperture),
        ],
        "auto exposure settings": [
            f32_property("adjustment speed", g.adjustment_speed),
            f32_property("target luminance", g.target_luminance),
        ],
        "tone mapping settings": [
            f32_property("saturation", g.saturation),
            f32_property("linear section", g.agx_ds_linear_section),
            f32_property("peak", g.peak),
            f32_property("compression", g.compression),
        ],
        "bloom settings": [
            f32_property("filter radius", g.filter_radius),
        ],
    }
