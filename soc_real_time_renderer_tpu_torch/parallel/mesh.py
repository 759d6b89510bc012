"""Batched multi-camera rendering on one card: B views of one scene in
one step.

Counterpart of the JAX package's ``parallel/mesh.py``
``make_batched_render_fn`` and ``batched_globals``.  There, ``jax.vmap``
of ``render_frame`` over the globals and the history gives every op and
every Pallas grid a batch axis (the ``dp`` axis of its mesh: a render
farm's independent cameras).  Here the same batch is a leading view axis
through ``graph/frame.py``: the scene's geometry, atlas and model
matrices are shared, its world transform is made once, the globals and
history carry (B, ...) leaves, and each CUDA kernel of the frame
launches once for the B views.  The step takes no mesh: one card holds
the batch.  The JAX module's row split of one frame over several
devices (``make_sharded_shade_fn``, ``parallel/halo.py``) has no
counterpart yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..config import stack_views, view_count
from ..graph import frame as frame_mod


def batched_globals(gs):
    """Stack a list of ShaderGlobals into batched globals: every leaf
    gains a leading view axis (scalars (B,), the light arrays (B, 128,
    ...), the camera and sun matrices (B, 4, 4))."""
    return stack_views(gs)


def batched_history(hs):
    """Stack a list of RenderHistory: (B, 3, H, W) and (B, 2, H, W) bf16
    colour and velocity, (B,) exposure."""
    return stack_views(hs)


def view_globals(built, positions, frame_index: int, prev_cameras=None):
    """([ShaderGlobals of each view], model_mats, normal_mats) of a
    BuiltScene at `frame_index` seen from each camera position: each
    view's camera_prev is its own camera of the previous frame
    (`prev_cameras`, a list of CameraMatrices; the view's own camera at
    the first frame).  `built.frame_globals` keeps one camera roll, so
    calling it once per view would give view b the camera of view b - 1
    as its previous one; this reads with peek=True and sets the roll per
    view.  The scene's camera_position is restored."""
    home = built.camera_position
    gs = []
    try:
        for b, pos in enumerate(positions):
            built.camera_position = np.asarray(pos, np.float32)
            g, model_mats, normal_mats = built.frame_globals(frame_index,
                                                             peek=True)
            if prev_cameras is not None:
                g = dataclasses.replace(g, camera_prev=prev_cameras[b])
            gs.append(g)
    finally:
        built.camera_position = home
    return gs, model_mats, normal_mats


def make_batched_render_fn(plan: frame_mod.FramePlan,
                           impl: str | None = None):
    """(batch, globals_batch, history_batch, model_mats, normal_mats) ->
    (colors (B, 3, H, W) f32, new history_batch): view b of the step is
    ``render_frame`` of globals b and history b.

    Before it dispatches anything it checks the elided shadow's sun proof
    against every view's sun (the JAX step's guard) and the shadow crop
    against the model matrices (which the JAX step leaves unchecked;
    ``render_frame`` checks both), and raises on a mismatch.  It runs on
    the device its tensors are on.  impl: as render_frame's."""
    def step(batch, globals_batch, history_batch, model_mats, normal_mats):
        B = view_count(globals_batch)
        if B is None:
            raise ValueError("globals_batch carries no view axis: stack "
                             "the views' globals with batched_globals")
        if (history_batch.exposure.shape != (B,)
                or history_batch.previous_color.shape[0] != B):
            raise ValueError(
                f"history_batch {tuple(history_batch.previous_color.shape)}"
                f" / {tuple(history_batch.exposure.shape)} does not hold "
                f"the {B} views of globals_batch")
        out, new_history = frame_mod.render_frame(
            plan, batch, globals_batch, history_batch, model_mats,
            normal_mats, impl=impl)
        return out.color, new_history

    return step
