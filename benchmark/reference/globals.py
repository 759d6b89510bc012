"""The reference's configuration, camera and per-frame globals.

Frozen copies of the port's ``config.py`` (``RenderConfig``'s fields and
defaults, ``ShaderGlobals.create``'s defaults as ``renderer.cpp:72-133``
sets them, ``SunInfo.create``, the plastic-number TAA jitter) and
``camera.py`` (the fly camera's update, ``camera.cpp:23-57``), so that
the reference makes each frame's globals itself from the camera that
the traffic drives: the preset's orbit (``BuiltScene.frame_globals``'s
``animate`` branch, each view's start turned about the target) or the
fly camera fed the traffic's inputs.  The point and spot lights are a
configuration's ``lights`` (:func:`lights_of`, ``scene.cpp:85-117``'s
gather), or none.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from . import mathutil as mu

MAX_POINT_LIGHTS = 128  # shared.inl:84
MAX_SPOT_LIGHTS = 128   # shared.inl:85
AUTO_EXPOSURE_BIN_COUNT = 256  # shared.inl:38
FOV, NEAR, FAR = 90.0, 0.1, 1000.0   # camera.hpp
MAX_ROT = 1.56825555556              # camera.cpp:37


@dataclass(frozen=True)
class RenderConfig:
    """The port's RenderConfig defaults, for the fields the reference
    frame reads."""
    width: int = 1280
    height: int = 720
    shadow_resolution: int = 4096
    bloom_mip_count: int = 4
    ssao_kernel_size: int = 26
    enable_shadows: bool = True
    enable_ssao: bool = True
    enable_clouds: bool = True
    cloud_noise_mode: str = "texture"
    cloud_fullscreen_rays: bool = False
    enable_bloom: bool = True
    enable_taa: bool = True
    enable_auto_exposure: bool = True
    max_point_lights: int = 0
    max_spot_lights: int = 0
    enable_ssr: bool = False
    composite_ssr: bool = False


def _f32(x):
    return np.asarray(x, dtype=np.float32)


def _tree_to(obj, device):
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _tree_to(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)})
    return torch.from_numpy(np.array(obj, order="C")).to(device)


@dataclass(frozen=True)
class Camera:
    projection: torch.Tensor
    inv_projection: torch.Tensor
    view: torch.Tensor
    inv_view: torch.Tensor
    projection_view: torch.Tensor
    inv_projection_view: torch.Tensor
    position: torch.Tensor
    jitter: torch.Tensor


@dataclass(frozen=True)
class Sun:
    projection: torch.Tensor
    view: torch.Tensor
    projection_view: torch.Tensor
    terrain_y_clip_trick: torch.Tensor
    position: torch.Tensor
    direction: torch.Tensor
    exponential_factor: torch.Tensor
    darkening_factor: torch.Tensor
    bias: torch.Tensor
    intensity: torch.Tensor


@dataclass(frozen=True)
class Lights:
    point_position: torch.Tensor
    point_color: torch.Tensor
    point_intensity: torch.Tensor
    point_count: torch.Tensor
    spot_position: torch.Tensor
    spot_direction: torch.Tensor
    spot_color: torch.Tensor
    spot_intensity: torch.Tensor
    spot_cut_off: torch.Tensor
    spot_outer_cut_off: torch.Tensor
    spot_count: torch.Tensor


@dataclass(frozen=True)
class Globals:
    camera: Camera
    camera_prev: Camera
    camera_near_clip: torch.Tensor
    camera_far_clip: torch.Tensor
    elapsed_time: torch.Tensor
    delta_time: torch.Tensor
    frame_counter: torch.Tensor
    sun: Sun
    lights: Lights
    terrain_offset: torch.Tensor
    terrain_scale: torch.Tensor
    terrain_height_scale: torch.Tensor
    terrain_midpoint: torch.Tensor
    terrain_delta: torch.Tensor
    terrain_min_depth: torch.Tensor
    terrain_max_depth: torch.Tensor
    terrain_y_clip_trick: torch.Tensor
    terrain_previous_y_clip_trick: torch.Tensor
    filter_radius: torch.Tensor
    ssao_bias: torch.Tensor
    ssao_radius: torch.Tensor
    ambient: torch.Tensor
    ambient_occlussion_strength: torch.Tensor
    emissive_bloom_strength: torch.Tensor
    focal_length: torch.Tensor
    plane_in_focus: torch.Tensor
    aperture: torch.Tensor
    adjustment_speed: torch.Tensor
    log_min_luminance: torch.Tensor
    log_max_luminance: torch.Tensor
    target_luminance: torch.Tensor
    saturation: torch.Tensor
    agx_ds_linear_section: torch.Tensor
    peak: torch.Tensor
    compression: torch.Tensor


def plastic_jitter(index, width, height):
    """TAA sub-pixel jitter, application.cpp:113-127 (index mod 32)."""
    g = 1.32471795724474602596
    a1 = np.float32(1.0 / g)
    a2 = np.float32(1.0 / (g * g))
    i = np.float32(int(index) % 32)
    jx = np.mod(np.float32(0.5) + a1 * (i + np.float32(1.0)),
                np.float32(1.0)) - np.float32(0.5)
    jy = np.mod(np.float32(0.5) + a2 * (i + np.float32(1.0)),
                np.float32(1.0)) - np.float32(0.5)
    return np.array([jx / np.float32(width), jy / np.float32(height)],
                    np.float32)


def camera_matrices(view, position, frame_index, width, height):
    """The jittered camera set of one frame (host numpy)."""
    proj = mu.perspective(FOV, float(width) / float(height), NEAR, FAR)
    j = plastic_jitter(frame_index, width, height)
    proj[0, 3] += j[0]
    proj[1, 3] += j[1]
    proj, view = _f32(proj), _f32(view)
    return Camera(
        projection=proj, inv_projection=np.linalg.inv(proj).astype(np.float32),
        view=view, inv_view=np.linalg.inv(view).astype(np.float32),
        projection_view=(proj @ view).astype(np.float32),
        inv_projection_view=np.linalg.inv(proj @ view).astype(np.float32),
        position=_f32(position), jitter=_f32(j))


def default_sun():
    """SunInfo.create() (renderer.cpp:108-133, angle renderer.hpp:67)."""
    d = np.array([0.0, -1.0, 0.0], np.float32)
    d = mu.rotate_x(d, np.radians(4.0))
    d = mu.rotate_y(d, np.radians(0.0))
    d = mu.rotate_z(d, np.radians(0.0))
    proj = mu.orthographic(-16.0, 16.0, -16.0, 16.0, -16.0, 16.0)
    pos = _f32((-3.2, 40.0, -4.0))
    view = mu.look_at(pos, pos + d, np.array([0.0, -1.0, 0.0], np.float32))
    pv = (proj @ view).astype(np.float32)
    return Sun(projection=proj, view=view, projection_view=pv,
               terrain_y_clip_trick=_f32(pv @ np.array([0.0, 1.0, 0.0, 0.0],
                                                       np.float32)),
               position=pos, direction=_f32(d),
               exponential_factor=_f32(-80.0), darkening_factor=_f32(1.0),
               bias=_f32(1e-4), intensity=_f32(1.0))


def no_lights():
    z3 = np.zeros((MAX_POINT_LIGHTS, 3), np.float32)
    z1 = np.zeros((MAX_POINT_LIGHTS,), np.float32)
    return Lights(point_position=z3, point_color=z3, point_intensity=z1,
                  point_count=np.int32(0), spot_position=z3,
                  spot_direction=z3, spot_color=z3, spot_intensity=z1,
                  spot_cut_off=z1, spot_outer_cut_off=z1,
                  spot_count=np.int32(0))


def lights_of(spec: dict) -> Lights:
    """The 128-slot light arrays of a configuration's ``lights``:
    ``{"point": [{position, color, intensity}], "spot": [{position,
    rotation_deg, color, intensity, cut_off_deg, outer_cut_off_deg}]}``.
    As scene.cpp:85-117 gathers them: a spot's direction is (0, -1, 0)
    rotated about x, then y, then z by its float angles, its cutoffs
    are stored as cosines, and only the first 128 of each kind count."""
    point = list(spec.get("point", []))[:MAX_POINT_LIGHTS]
    spot = list(spec.get("spot", []))[:MAX_SPOT_LIGHTS]

    def slots(rows, dim):
        out = np.zeros((MAX_POINT_LIGHTS, dim) if dim > 1
                       else (MAX_POINT_LIGHTS,), np.float32)
        for i, r in enumerate(rows):
            out[i] = r
        return out

    def direction(rotation_deg):
        r = np.asarray(rotation_deg, np.float32)
        d = np.array([0.0, -1.0, 0.0], np.float32)
        d = mu.rotate_x(d, np.radians(r[0]))
        d = mu.rotate_y(d, np.radians(r[1]))
        return mu.rotate_z(d, np.radians(r[2]))

    return Lights(
        point_position=slots([p["position"] for p in point], 3),
        point_color=slots([p["color"] for p in point], 3),
        point_intensity=slots([p["intensity"] for p in point], 1),
        point_count=np.int32(len(point)),
        spot_position=slots([s["position"] for s in spot], 3),
        spot_direction=slots([direction(s["rotation_deg"]) for s in spot], 3),
        spot_color=slots([s["color"] for s in spot], 3),
        spot_intensity=slots([s["intensity"] for s in spot], 1),
        spot_cut_off=slots([np.cos(np.radians(s["cut_off_deg"]))
                            for s in spot], 1),
        spot_outer_cut_off=slots([np.cos(np.radians(s["outer_cut_off_deg"]))
                                  for s in spot], 1),
        spot_count=np.int32(len(spot)))


def frame_globals(camera, camera_prev, frame_index: int, dt: float,
                  device, lights: Lights | None = None) -> Globals:
    """ShaderGlobals.create's defaults around this frame's camera sets,
    with `lights` (:func:`lights_of`; default none)."""
    sun = default_sun()
    target_luminance = 0.2140
    g = Globals(
        camera=camera, camera_prev=camera_prev,
        camera_near_clip=_f32(NEAR), camera_far_clip=_f32(FAR),
        elapsed_time=_f32(np.float32(frame_index * dt)),
        delta_time=_f32(np.float32(dt)),
        frame_counter=np.int32(frame_index), sun=sun,
        lights=no_lights() if lights is None else lights,
        terrain_offset=_f32([0.0, 0.0, 0.0]),
        terrain_scale=_f32([100.0, 100.0]),
        terrain_height_scale=_f32(70.0), terrain_midpoint=_f32(0.2),
        terrain_delta=_f32(8.0), terrain_min_depth=_f32(1.0),
        terrain_max_depth=_f32(100.0),
        terrain_y_clip_trick=sun.terrain_y_clip_trick,
        terrain_previous_y_clip_trick=sun.terrain_y_clip_trick,
        filter_radius=_f32(0.005), ssao_bias=_f32(0.025),
        ssao_radius=_f32(0.3), ambient=_f32([0.1, 0.1, 0.1]),
        ambient_occlussion_strength=_f32(1.2),
        emissive_bloom_strength=_f32(2.0), focal_length=_f32(5.0),
        plane_in_focus=_f32(1.0), aperture=_f32(8.0),
        adjustment_speed=_f32(1.0),
        log_min_luminance=_f32(np.log2(target_luminance / np.exp2(-15.0))),
        log_max_luminance=_f32(np.log2(target_luminance / np.exp2(15.0))),
        target_luminance=_f32(target_luminance), saturation=_f32(1.0),
        agx_ds_linear_section=_f32(0.18), peak=_f32(1.0),
        compression=_f32(0.15))
    return _tree_to(g, device)


class Orbit:
    """The preset's animated camera: 0.25 rad per simulated second around
    the target (BuiltScene.frame_globals with ``animate``), started at
    `position` turned by `turn` rad about the target (a view of the
    batched step)."""

    def __init__(self, position, target, turn: float = 0.0):
        self.position = _f32(position)
        self.target = _f32(target)
        if turn:
            c, s = np.cos(turn), np.sin(turn)
            rel = self.position - self.target
            self.position = self.target + np.array(
                [c * rel[0] - s * rel[2], rel[1], s * rel[0] + c * rel[2]],
                np.float32)

    def pose(self, frame_index: int, dt: float, inputs=None):
        ang = 0.25 * frame_index * dt
        c, s = np.cos(ang), np.sin(ang)
        rel = self.position - self.target
        pos = self.target + np.array([c * rel[0] - s * rel[2], rel[1],
                                      s * rel[0] + c * rel[2]], np.float32)
        return mu.look_at(pos, self.target,
                          np.array([0., 1., 0.], np.float32)), pos


class Fly:
    """The viewer's fly camera (camera.cpp:23-57), started at the
    preset's camera looking at its target; ``pose`` applies one frame's
    input (a dict of the InputState fields) first."""

    def __init__(self, position, target, mouse_sens: float = 0.1,
                 sprint_speed: float = 8.0):
        self.position = _f32(position).copy()
        rel = _f32(target) - self.position
        self.rotation = np.array(
            [np.arctan2(rel[2], rel[0]),
             -np.arcsin(rel[1] / max(np.linalg.norm(rel), 1e-6)), 0.0],
            np.float32)
        self.mouse_sens, self.sprint_speed = mouse_sens, sprint_speed

    def pose(self, frame_index: int, dt: float, inputs=None):
        inp = dict(inputs or {})
        captured = inp.get("cursor_captured", True)
        if captured:
            self.rotation[0] += inp.get("cursor_dx", 0.0) * self.mouse_sens \
                * 1e-4 * FOV
            self.rotation[1] += inp.get("cursor_dy", 0.0) * self.mouse_sens \
                * 1e-4 * FOV
        self.rotation[1] = np.clip(self.rotation[1], -MAX_ROT, MAX_ROT)
        rx, ry = float(self.rotation[0]), float(self.rotation[1])
        forward = np.array([np.cos(rx) * np.cos(ry), -np.sin(ry),
                            np.sin(rx) * np.cos(ry)], np.float32)
        forward /= np.linalg.norm(forward)
        up = np.array([0.0, 1.0, 0.0], np.float32)
        right = np.cross(forward, up)
        right /= np.linalg.norm(right)
        move = np.zeros(3, np.float32)
        if captured:
            for key, vec, sign in (("forward", forward, 1), ("back", forward,
                                   -1), ("right", right, 1),
                                   ("left", right, -1), ("up", up, 1),
                                   ("down", up, -1)):
                if inp.get(key, False):
                    move = move + vec if sign > 0 else move - vec
        speed = self.sprint_speed if inp.get("sprint", False) else 2.0
        self.position = (self.position + move * dt * speed * 7.5).astype(
            np.float32)
        return mu.look_at(self.position, self.position + forward,
                          up), self.position.copy()
