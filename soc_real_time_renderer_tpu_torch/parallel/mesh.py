"""Several views of one scene in one step, and one frame split in row
bands over a mesh of devices.

Counterpart of the JAX package's ``parallel/mesh.py``.

* ``make_batched_render_fn``, ``batched_globals``: there ``jax.vmap`` of
  ``render_frame`` over the globals and the history gives every op and
  every Pallas grid a batch axis (the ``dp`` axis of its mesh: a render
  farm's independent cameras).  Here the same batch is a leading view
  axis through ``graph/frame.py``: the scene's geometry, atlas and model
  matrices are shared, its world transform is made once, the globals and
  history carry (B, ...) leaves, and each CUDA kernel of the frame
  launches once for the B views.
* ``make_mesh``, ``shard_inputs``, ``make_sharded_shade_fn`` and the
  ``mesh`` argument of ``make_batched_render_fn``: the row split of one
  frame.  JAX runs it as single-controller SPMD over a
  ``jax.sharding.Mesh``; here one process drives a (dp, sp) array of
  ``torch.device`` (:class:`Mesh`), each band's kernels launching on the
  band's device with the band's screen rows (``parallel/halo.py``).  The
  device array may name one device several times (``["cuda:0"] * 4``
  on one card, ``["cpu"] * 8`` in the tests): the bands then run one
  after another on it, exactly as they would on distinct cards, which is
  the property the split must keep (the frame's result does not depend
  on it).  Replicated inputs are held once per distinct device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

import torch

from ..config import stack_views, tree_map, view_count
from ..graph import frame as frame_mod
from . import halo


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, sp) array of torch devices with the axis names of the JAX
    mesh: ``dp`` views (independent cameras), ``sp`` row bands of one
    frame.  ``devices[i][j]`` is the device of view group i, band j."""
    devices: tuple
    axis_names: tuple = ("dp", "sp")

    @property
    def shape(self) -> dict:
        return {"dp": len(self.devices), "sp": len(self.devices[0])}

    def band_devices(self, axis: str) -> list:
        """The devices along `axis` (the other axis must be 1: a row split
        runs over one group's devices, see :meth:`group`)."""
        if axis not in self.axis_names:
            raise ValueError(f"no mesh axis {axis!r} in {self.axis_names}")
        other = self.shape["dp" if axis == "sp" else "sp"]
        if other != 1:
            raise ValueError(f"a split over {axis!r} takes a mesh whose "
                             f"other axis is 1, not {self.shape}: take "
                             f"one group with Mesh.group")
        if axis == "sp":
            return list(self.devices[0])
        return [row[0] for row in self.devices]

    def group(self, i: int) -> "Mesh":
        """View group i: the (1, sp) mesh of its devices."""
        return Mesh(devices=(self.devices[i],), axis_names=self.axis_names)

    @property
    def distinct_devices(self) -> list:
        return halo.distinct(d for row in self.devices for d in row)


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              devices=None) -> Mesh:
    """A (dp, sp) mesh of `n_devices` devices (default all of them): the
    visible CUDA devices, or the explicit `devices` (e.g. ["cuda:0"] * 4
    on one card, ["cpu"] * 8 in the tests), taken in order.  dp defaults
    to 2 where n is even and above 1, as the JAX make_mesh's; sp = n /
    dp.  Raises where n exceeds the devices, where dp does not divide n,
    or where no device is given and no card is visible: the mesh is
    never shrunk, nor moved to the CPU."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("no CUDA device for the mesh: pass devices "
                               "(e.g. ['cpu'] * 8) to build one elsewhere")
    devices = [_device(d) for d in devices]
    n = len(devices) if n_devices is None else n_devices
    if not 1 <= n <= len(devices):
        raise ValueError(f"a mesh of {n} devices asked for, "
                         f"{len(devices)} available")
    if dp is None:
        dp = 2 if n % 2 == 0 and n > 1 else 1
    if dp < 1 or n % dp:
        raise ValueError(f"dp = {dp} does not divide {n} devices")
    sp = n // dp
    return Mesh(devices=tuple(tuple(devices[i * sp:(i + 1) * sp])
                              for i in range(dp)))


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


def _check_views(globals_batch, history_batch):
    """The view count B of the step's globals (one batched tree, or a
    list of one per view group of the meshed step), after checking that
    the history (likewise) holds B views."""
    counts = [view_count(g) for g in (globals_batch
                                      if isinstance(globals_batch, list)
                                      else [globals_batch])]
    if None in counts:
        raise ValueError("globals_batch carries no view axis: stack "
                         "the views' globals with batched_globals")
    B = sum(counts)
    groups = (history_batch if isinstance(history_batch, list)
              else [history_batch])
    colour = [h.previous_color for h in groups]
    colour = [c[0] if isinstance(c, list) else c for c in colour]
    if (sum(h.exposure.shape[0] if h.exposure.dim() else 0 for h in groups)
            != B or sum(c.shape[0] if c.dim() == 4 else 0 for c in colour)
            != B):
        raise ValueError(
            f"history_batch {[tuple(c.shape) for c in colour]} / "
            f"{[tuple(h.exposure.shape) for h in groups]} does not hold "
            f"the {B} views of globals_batch")
    return B


def make_batched_render_fn(plan: frame_mod.FramePlan,
                           impl: str | None = None, mesh: Mesh | None = None,
                           row_axis: str = "sp"):
    """(batch, globals_batch, history_batch, model_mats, normal_mats) ->
    (colors (B, 3, H, W) f32, new history_batch): view b of the step is
    ``render_frame`` of globals b and history b.

    Before it dispatches anything it checks the elided shadow's sun proof
    against every view's sun (the JAX step's guard) and the shadow crop
    against the model matrices (which the JAX step leaves unchecked;
    ``render_frame`` checks both), and raises on a mismatch.  It runs on
    the device its tensors are on.  impl: as render_frame's.

    mesh: the views split over its ``dp`` axis in dp equal groups (B a
    multiple of dp), each group's frame split in row bands over the
    group's devices on `row_axis` (the plan's row split, see
    :func:`make_sharded_shade_fn`).  The inputs may be one batched tree
    each or :func:`shard_inputs`' (the batch's replicas, a list per
    group of globals and of history); a history may also be the step's
    own output.  The step returns colors and history as a list of one
    entry per group: the group's (B / dp, 3, h_j, W) colour bands, and
    its RenderHistory with band images (:func:`assemble_views` /
    :func:`assemble_history` put them together)."""
    def step(batch, globals_batch, history_batch, model_mats, normal_mats):
        _check_views(globals_batch, history_batch)
        out, new_history = frame_mod.render_frame(
            plan, batch, globals_batch, history_batch, model_mats,
            normal_mats, impl=impl)
        return out.color, new_history

    if mesh is None:
        return step
    dp = mesh.shape["dp"]
    plans = [dataclasses.replace(plan, shard_mesh=mesh.group(j),
                                 shard_axis=row_axis) for j in range(dp)]

    def groups(x, per):
        if isinstance(x, list):
            if len(x) != dp:
                raise ValueError(f"{len(x)} view groups for dp = {dp}")
            return x
        return [tree_map(lambda v: v[j * per:(j + 1) * per], x)
                for j in range(dp)]

    def meshed(batch, globals_batch, history_batch, model_mats, normal_mats):
        B = _check_views(globals_batch, history_batch)
        if B % dp:
            raise ValueError(f"{B} views do not split into dp = {dp} "
                             f"groups")
        gs = groups(globals_batch, B // dp)
        hs = groups(history_batch, B // dp)
        # every view's proofs before anything is dispatched
        for g in gs:
            frame_mod.check_sun_proof(plan, g)
        frame_mod.check_shadow_crop(plan, model_mats)
        colors, hists = [], []
        for p, g, h in zip(plans, gs, hs):
            out, h2 = frame_mod.render_frame(p, batch, g, h, model_mats,
                                             normal_mats, impl=impl)
            colors.append(out.color)
            hists.append(h2)
        return colors, hists

    return meshed


def assemble_views(groups, device):
    """The meshed step's colour (a list per view group of row bands) ->
    one (B, 3, H, W) tensor on `device`."""
    return torch.cat([halo.assemble(bands, device) for bands in groups])


def assemble_history(hists, device):
    """The meshed step's history (a RenderHistory per view group, its
    images row bands) -> one batched RenderHistory on `device`."""
    def whole(x):
        return (halo.assemble(x, device) if isinstance(x, list)
                else x.to(device))
    return frame_mod.RenderHistory(
        previous_color=torch.cat([whole(h.previous_color) for h in hists]),
        previous_velocity=torch.cat([whole(h.previous_velocity)
                                     for h in hists]),
        exposure=torch.cat([h.exposure.to(device).reshape(-1)
                            for h in hists]))


def make_sharded_shade_fn(plan: frame_mod.FramePlan, mesh: Mesh,
                          row_axis: str = "sp", impl: str | None = None):
    """(batch, g, history, vis, records, shadow_map, overflow) -> (colour
    bands, new history): ``shade_stage`` of one frame (or a batch of
    views) in row bands over the devices of mesh axis `row_axis` (the
    mesh's other axis must be 1; one group of a larger mesh is
    ``mesh.group(j)``).  Its inputs are raster_stage's, of the plan
    split alike (bands and replicas) or not (whole tensors, cut here);
    the new history's images are row bands, its exposure on the axis's
    first device.  Bands are even-height and as equal as that allows
    (``halo.band_starts``): an odd height, or fewer row pairs than
    bands, raises.  impl: as render_frame's.

    How each pass runs:

    * per band, with its halo where it reads neighbours, on the band's
      device with the band's screen rows: the G-buffer resolve and
      its material tap (K9, no halo: per pixel); the SSAO preamble and its
      taps (K2), the 4x4 blur (2 + 1 half-res halo rows) and the
      upsample (1 + 1); the sky LUT lookup of the clouds (its half-res
      rows and one either side, for the upsample); composition (per
      pixel, the volumetric term included); the SSR mix; the TAA
      resolve (K3f: its 3x3 neighbourhood and velocity dilation read a
      1-row halo); tone mapping.
    * on the whole screen, gathered once per distinct device (or on the
      axis's first device): the depth that K2's taps and the clouds'
      QUADRANT taps read (a tap lands anywhere on the screen; the JAX
      Pallas band mode's bounded halos rest on a TPU-only window clamp
      that the exact path does not make); the previous colour and
      velocity that K3f's history fetch reads; the shadow map the
      composition samples; HiZ; bloom's mip chain (its reach grows
      with each level); and the passes that are off by default: SSR,
      depth of field and the per-pixel cloud march, each then cut back
      into bands.
    * as a reduction summed over bands: the exposure histogram (int64
      counts, so the sum is exact), resolved once.

    The sky LUT (K6, or K6p over the procedural noise) is made once per
    distinct device from the replicated globals; the raster's K1 and K4
    run once per band of bin rows (raster_stage,
    raster2.resolve_row_sharded).
    Each band's values are the unsplit frame's rows."""
    plan = dataclasses.replace(plan, shard_mesh=mesh, shard_axis=row_axis)
    mesh.band_devices(row_axis)

    def shade(batch, g, history, vis, records, shadow_map, overflow):
        out, h2 = frame_mod.shade_stage(plan, batch, g, history, vis,
                                        records, shadow_map, overflow,
                                        impl=impl)
        return out.color, h2

    return shade


def shard_inputs(mesh: Mesh, batch, globals_batch, history_batch,
                 row_axis: str = "sp"):
    """Place the inputs of the meshed step: the scene's batch replicated
    ({device: batch}, one copy per distinct device), the globals of view
    group j on its first device (a list per group), the history's images
    cut in row bands over group j's devices (a RenderHistory per group,
    the exposure on the group's first device)."""
    dp = mesh.shape["dp"]
    B = view_count(globals_batch)
    if B is None or B % dp:
        raise ValueError(f"{B} views do not split into dp = {dp} groups")
    per = B // dp
    batches = halo.replicate(batch, mesh.distinct_devices)
    gs, hs = [], []
    for j in range(dp):
        devices = mesh.group(j).band_devices(row_axis)

        def views(x):
            return x[j * per:(j + 1) * per]

        gs.append(halo.move(tree_map(views, globals_batch), devices[0]))
        hs.append(frame_mod.RenderHistory(
            previous_color=halo.split_rows(
                views(history_batch.previous_color), devices),
            previous_velocity=halo.split_rows(
                views(history_batch.previous_velocity), devices),
            exposure=views(history_batch.exposure).to(devices[0])))
    return batches, gs, hs
