"""Carry the JAX package's objects across to the port.

Each function takes an object of ``soc_real_time_renderer_tpu`` (a
``SceneBatch`` of any number of models, its ``cloud_noise`` included; a
``ShaderGlobals`` with the per-entity matrices of a frame; a
``RenderHistory`` or a ``FramePlan``)
whose array leaves are numpy arrays or anything ``np.asarray`` accepts,
reads it by field name (duck-typed: this module imports no jax), and
returns the port's object with tensors on ``device``.  The parity tests
use it so that both packages compute on identical inputs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import config as cfg
from .graph import frame as frame_mod
from .models.scene_batch import SceneBatch
from .ops import raster2


def to_tensor(x, device="cpu"):
    """numpy-compatible array -> tensor, bfloat16 (ml_dtypes) included."""
    a = np.array(x, order="C")          # a writable copy, 0-d kept
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _fields(cls, src, convert):
    return cls(**{f.name: convert(f, getattr(src, f.name))
                  for f in dataclasses.fields(cls)})


def _tensor_tree(cls, src, device):
    """Port dataclass `cls` from `src`, recursing into nested dataclass
    fields and turning every other leaf into a tensor."""
    nested = {"camera": cfg.CameraMatrices, "camera_prev": cfg.CameraMatrices,
              "sun": cfg.SunInfo, "lights": cfg.LightArrays}

    def convert(f, v):
        if f.name in nested:
            return _tensor_tree(nested[f.name], v, device)
        return None if v is None else to_tensor(v, device)

    return _fields(cls, src, convert)


def scene_batch_from_numpy(batch, device="cpu") -> SceneBatch:
    return SceneBatch(
        tri_pos=to_tensor(batch.tri_pos, device),
        tri_nrm=to_tensor(batch.tri_nrm, device),
        tri_uv=to_tensor(batch.tri_uv, device),
        tri_entity=to_tensor(batch.tri_entity, device),
        static_rows=to_tensor(batch.static_rows, device),
        atlas_packed=to_tensor(batch.atlas_packed, device),
        cloud_noise=(None if batch.cloud_noise is None
                     else to_tensor(batch.cloud_noise, device)))


def globals_from_numpy(g, device="cpu") -> cfg.ShaderGlobals:
    return _tensor_tree(cfg.ShaderGlobals, g, device)


def frame_inputs_from_numpy(g, model_mats, normal_mats, device="cpu"):
    """What a JAX ``BuiltScene.frame_globals`` returns -> the port's
    (ShaderGlobals, (E, 4, 4) model matrices, (E, 4, 4) normal
    matrices), one matrix per mesh entity."""
    return (globals_from_numpy(g, device), to_tensor(model_mats, device),
            to_tensor(normal_mats, device))


def history_from_numpy(h, device="cpu") -> frame_mod.RenderHistory:
    return frame_mod.RenderHistory(
        previous_color=to_tensor(h.previous_color, device),
        previous_velocity=to_tensor(h.previous_velocity, device),
        exposure=to_tensor(h.exposure, device).to(torch.float32))


# The JAX package's batched pytrees (parallel/mesh.batched_globals and a
# stacked RenderHistory: every leaf (B, ...)) convert leaf by leaf alike,
# into the port's batched globals and history (parallel/mesh.py).
batched_globals_from_numpy = globals_from_numpy
batched_history_from_numpy = history_from_numpy


def grid_from_jax(grid) -> raster2.BinGrid:
    """The port's BinGrid from the JAX one: the fields both have (the
    TPU record-format fields are dropped, the port's own ``large_cap``
    keeps its default)."""
    return raster2.BinGrid(**{f.name: getattr(grid, f.name)
                              for f in dataclasses.fields(raster2.BinGrid)
                              if hasattr(grid, f.name)})


def plan_from_jax_plan(plan) -> frame_mod.FramePlan:
    """The port's FramePlan from the JAX one: same config and grids
    (the TPU record-format fields of BinGrid are dropped, the port
    always streams f32 records); TPU-only plan fields are dropped.  A
    plan split over a JAX mesh raises: the port's row split takes its
    own mesh of torch devices (parallel/mesh.make_mesh)."""
    if getattr(plan, "shard_mesh", None) is not None:
        raise ValueError("the JAX plan is split over a JAX mesh: set the "
                         "port plan's shard_mesh to a parallel/mesh.Mesh")

    def convert(f, v):
        if f.name == "config":
            return _fields(cfg.RenderConfig, v, lambda _, x: x)
        if f.name in ("main_grid", "shadow_grid"):
            return grid_from_jax(v)
        return v

    return _fields(frame_mod.FramePlan, plan, convert)
