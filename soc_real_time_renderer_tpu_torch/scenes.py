"""Scene presets -> BuiltScene (batch, plan, per-frame globals).

Counterpart of the JAX package's ``scenes.py``.  A scene is an ECS
:class:`~.scene.scene.Scene` of mesh entities (TRS transforms, lights);
:func:`_finish` packs its models into one batch and runs the same
host-side proofs as the JAX package: the light-count bounds of the
composition loops, the data-sized pair caps of both bin grids, the SSR
compaction cap, and the sun-shadow proof (``_prove_shadow``): either the
map is statically empty (the shadow raster is elided) or a 128-aligned
texel crop is proved to hold every texel below the 1.0 clear, for these
transforms.  It also reads the cloud-noise texture
``ASSETS/Clouds/noise.png`` when the file exists.

The presets (:func:`build`): ``helmet``, ``helmet_lifted``, ``sponza``,
``terrain`` and ``full`` (BASELINE configs 1-6), ``sponza_lifted``
(``sponza`` inside the sun's volume, animated: the paid 4096^2 shadow
view through its proved crop), ``full_lit`` (``full`` with the
globals' 128 point and 128 spot light slots filled, laid out by
:func:`full_lit_lights`) and ``full_ssr`` (``full`` whose atrium floor
is polished metal and stone tiles, with a screen-sized SSR cap).  All
but ``terrain`` read the asset tree under ``ASSETS`` (``SOC_ASSETS``):
``DamagedHelmet/glTF/DamagedHelmet.gltf`` and, for the atrium's
materials, ``Sponza/glTF``; a missing helmet raises
``FileNotFoundError`` naming the file.  ``terrain`` takes
``SOC_TERRAIN_HEIGHTMAP`` / ``SOC_TERRAIN_ALBEDO`` when set.

Entry points run on the CUDA card unless the caller passes a device
(``device="cpu"`` runs every kernel's plain PyTorch version).
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import numpy as np
import torch

from .camera import Camera3D, ControlledCamera3D, camera_matrices
from .config import (RenderConfig, ShaderGlobals, SunInfo, resolve_device,
                     upload)
from .graph import frame as frame_mod
from .models import gltf, proc
from .models.scene_batch import SceneBatch, build_scene_batch
from .models.texture import decode_image
from .ops import raster2
from .scene.components import (MeshComponent, PointLightComponent,
                               SpotLightComponent, TransformComponent)
from .scene.scene import Scene
from .utils import mathutil as mu
from .utils import trace

# the asset tree (SOC_ASSETS, default: assets/ of the checkout)
ASSETS = os.environ.get("SOC_ASSETS", os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets"))


@dataclass
class BuiltScene:
    scene: Scene
    batch: SceneBatch
    plan: frame_mod.FramePlan
    camera: Camera3D
    camera_position: np.ndarray
    camera_target: np.ndarray
    device: torch.device
    animate: bool = False
    sun: SunInfo | None = None    # None: the default sun
    ssr_cap: int | None = None    # the build's SSR cap (None: _finish's
    #                               5% rule), which a full rebuild keeps

    # FramePlan fields the viewer may set after the build, which a full
    # rebuild keeps: of the JAX package's list, the fields the port's
    # FramePlan has (ssr_cap is re-derived by _finish in both packages)
    _PLAN_OVERRIDES = ("texture_filter", "shard_mesh", "shard_axis")

    def apply_input(self, inp, dt: float) -> None:
        """Fly-camera input (ControlledCamera3D) from the viewer.  The
        first call starts the fly camera at camera_position, looking at
        camera_target, and stops the preset's animation."""
        with trace.span("scene.apply_input"):
            if not hasattr(self, "_fly"):
                self._fly = ControlledCamera3D(camera=self.camera)
                self._fly.position = np.asarray(self.camera_position,
                                                np.float32).copy()
                rel = self.camera_target - self.camera_position
                self._fly.rotation = np.array(
                    [np.arctan2(rel[2], rel[0]),
                     -np.arcsin(rel[1] / max(np.linalg.norm(rel), 1e-6)),
                     0.0], np.float32)
                self.animate = False
            self._fly.update(inp, dt)

    def set_sun(self, position=None, angle_direction_deg=None) -> None:
        """Live sun edit (the reference's sun-position control,
        renderer.cpp:683-767): new sun matrices on the scene's device.
        The shadow proof holds for the old sun until rebuild() re-proves
        it (check_sun_proof rejects a frame in between)."""
        kw = {}
        if position is not None:
            kw["position"] = tuple(float(v) for v in position)
        if angle_direction_deg is not None:
            kw["angle_direction_deg"] = tuple(
                float(v) for v in angle_direction_deg)
        self.sun = SunInfo.create(**kw, device=self.device)

    def mesh_signature(self):
        """Identity of the renderable mesh set: changes exactly when the
        batch must be re-packed (a mesh entity added or removed, or a
        model swapped)."""
        return tuple((e.eid, id(e.get_component(MeshComponent).model))
                     for e in self.scene.mesh_entities())

    def rebuild(self) -> None:
        """Re-derive the render state from the live scene; keeps the
        camera, the fly state and _PLAN_OVERRIDES.  Two tiers:

        * the same models (element by element, `is`): re-bound the light
          scans to the live light counts and re-prove the shadow against
          the live transforms and sun; the batch stays.  Its host copies
          of the triangle stream are pulled once and kept, since a
          device-to-host copy of every triangle at each edit would stall
          the render loop;
        * other models: _finish re-packs batch, atlas and plan.

        Does nothing when no mesh entity is left (an empty batch has no
        triangle stream)."""
        models = [e.get_component(MeshComponent).model
                  for e in self.scene.mesh_entities()]
        if not models:
            return
        old = self.plan
        prev = getattr(self, "_models", None)
        same = (prev is not None and len(prev) == len(models)
                and all(a is b for a, b in zip(prev, models)))
        if same:
            lights = self.scene.update(0.0)
            cfg2 = old.config.replace(
                max_point_lights=int(lights.point_count),
                max_spot_lights=int(lights.spot_count))
            mm, _ = self.scene.transform_matrices()
            if getattr(self, "_proof_pos", None) is None:
                self._proof_pos = self.batch.tri_pos.cpu().numpy()
                self._proof_ent = self.batch.tri_entity.cpu().numpy()
            self.plan = _with_proof(dataclasses.replace(old, config=cfg2),
                                    self._proof_pos, self._proof_ent, mm,
                                    self.sun)
        else:
            nb = _finish(self.scene, models, old.config,
                         camera_pos=self.camera_position,
                         camera_target=self.camera_target,
                         animate=self.animate, atlas_size=old.atlas_size,
                         sun=self.sun, ssr_cap=self.ssr_cap,
                         device=self.device)
            self.batch = nb.batch
            self._proof_pos = self._proof_ent = None
            self.plan = dataclasses.replace(
                nb.plan, **{f: getattr(old, f) for f in self._PLAN_OVERRIDES})
        self._models = list(models)

    def resize(self, width: int, height: int) -> None:
        """The reference's resize path (swapchain resize + framebuffer
        recreation, renderer.cpp:815-881, + camera.resize,
        application.cpp:96-100): the config's size, the main bin grid
        re-capped for the live batch and the camera's projection; the
        prev-camera roll restarts.  Batch, atlas, shadow grid, proof and
        overrides stay.  The caller makes a new RenderHistory (and
        render function) for the new size.

        Width and height must be multiples of 32 and at least 64, else
        ValueError: the JAX package's Pallas tile alignment, kept so that
        the port's viewer refuses exactly what the reference's refuses.
        The port's kernels need no such alignment: K2 and K3 take ragged
        and odd sizes (tests/test_torch_cuda.py runs them so on the
        card), K1 rounds the screen up to whole 64x32 bins and the frame
        crops its visibility buffer to the viewport, and K4, K5 and K6
        do not depend on the screen's size."""
        width, height = int(width), int(height)
        if width % 32 or height % 32 or width < 64 or height < 64:
            raise ValueError(
                f"resize: width/height must be multiples of 32 and "
                f">= 64, got {width}x{height}")
        cfg2 = self.plan.config.replace(width=width, height=height)
        main = _cap_grid(raster2.default_grid(width, height),
                         int(self.batch.num_triangles))
        self.plan = dataclasses.replace(self.plan, config=cfg2,
                                        main_grid=main)
        self.camera.resize(width, height)
        if hasattr(self, "_prev_cam"):
            del self._prev_cam

    def frame_globals(self, frame_index: int, dt: float = 1.0 / 60.0,
                      peek: bool = False):
        """Per-frame host update (Application::update + Scene::update):
        the camera (the fly camera once apply_input ran, else orbiting
        its target when `animate`), jitter, the prev-camera roll, the
        scene's lights and transforms -> (g, model_mats, normal_mats) on
        the scene's device.  peek=True reads without advancing the
        prev-camera roll (the viewer's /schema must not zero a frame's
        TAA reprojection velocity).  The frame's host leaves cross in one
        packed, non-blocking copy, after the host work (the span
        ``globals.upload``, config.upload)."""
        with trace.span("scene.frame_globals"):
            return self._frame_globals(frame_index, dt, peek)

    def _frame_globals(self, frame_index, dt, peek):
        with trace.span("globals.camera"):
            if hasattr(self, "_fly"):
                pos = self._fly.position  # update() wrote camera.view_mat
            else:
                pos = self.camera_position
                if self.animate:
                    ang = 0.25 * frame_index * dt
                    c, s = np.cos(ang), np.sin(ang)
                    rel = self.camera_position - self.camera_target
                    pos = self.camera_target + np.array(
                        [c * rel[0] - s * rel[2], rel[1],
                         s * rel[0] + c * rel[2]], np.float32)
                self.camera.view_mat = mu.look_at(
                    pos, self.camera_target,
                    np.array([0., 1., 0.], np.float32))
            cam = camera_matrices(self.camera, pos, frame_index,
                                  self.plan.config.width,
                                  self.plan.config.height)
        with trace.span("globals.lights"):
            lights = self.scene.update(dt)
            mm, nm = self.scene.transform_matrices()
        with trace.span("globals.upload"):
            g = ShaderGlobals.create(
                camera=cam, camera_prev=getattr(self, "_prev_cam", cam),
                lights=lights, sun=self.sun,
                near_clip=self.camera.near_clip,
                far_clip=self.camera.far_clip,
                elapsed_time=np.float32(frame_index * dt),
                delta_time=np.float32(dt),
                frame_counter=np.int32(frame_index), device=None)
            g, mm, nm = upload((g, mm, nm), self.device)
        if not peek:
            self._prev_cam = g.camera
        return g, mm, nm


def _prove_shadow(pos, ent, model_mats, sun_pv,
                  shadow_resolution: int | None = None):
    """(statically_empty, proved_sun_pv-or-None, shadow_crop-or-None) for
    the given host geometry (pos (3, 3, T), ent (T,)), transforms (E, 4,
    4) and sun projection_view — the JAX package's scenes._prove_shadow.
    The crop (only when not empty): the xy sun-NDC bbox of every vertex
    plus a 4-texel margin, 128-aligned, kept when under 70% of the map;
    every texel outside it is exactly the 1.0 clear."""
    empty, ndc = _shadow_statically_empty(pos, ent, model_mats, sun_pv)
    proved = None
    crop = None
    if empty:
        proved = tuple(float(v) for v in sun_pv.ravel())
    elif ndc is not None and shadow_resolution:
        x, y = ndc
        S = int(shadow_resolution)
        u0 = float(np.min(x)) * 0.5 + 0.5
        u1 = float(np.max(x)) * 0.5 + 0.5
        v0 = float(np.min(y)) * 0.5 + 0.5
        v1 = float(np.max(y)) * 0.5 + 0.5
        x0 = max(0, (int(np.floor(u0 * S)) - 4) // 128 * 128)
        y0 = max(0, (int(np.floor(v0 * S)) - 4) // 128 * 128)
        x1 = min(S, -(-(int(np.ceil(u1 * S)) + 4) // 128) * 128)
        y1 = min(S, -(-(int(np.ceil(v1 * S)) + 4) // 128) * 128)
        if x1 > x0 and y1 > y0 and (x1 - x0) * (y1 - y0) < 0.7 * S * S:
            crop = (x0, y0, x1 - x0, y1 - y0)
    return bool(empty), proved, crop


def _shadow_statically_empty(pos, ent, model_mats, sun_pv,
                             margin: float = 1e-4):
    """(all_excluded, (x, y) sun-NDC vertex coords or None): True iff
    every triangle lies beyond one common sun clip plane (all three
    vertices), so no fragment survives the shadow raster's clip."""
    M = model_mats[ent]
    pv = sun_pv
    zs, xs, ys = [], [], []
    for v in range(3):
        p = pos[v]
        wx = M[:, 0, 0] * p[0] + M[:, 0, 1] * p[1] + M[:, 0, 2] * p[2] + M[:, 0, 3]
        wy = M[:, 1, 0] * p[0] + M[:, 1, 1] * p[1] + M[:, 1, 2] * p[2] + M[:, 1, 3]
        wz = M[:, 2, 0] * p[0] + M[:, 2, 1] * p[1] + M[:, 2, 2] * p[2] + M[:, 2, 3]
        cx = pv[0, 0] * wx + pv[0, 1] * wy + pv[0, 2] * wz + pv[0, 3]
        cy = pv[1, 0] * wx + pv[1, 1] * wy + pv[1, 2] * wz + pv[1, 3]
        cz = pv[2, 0] * wx + pv[2, 1] * wy + pv[2, 2] * wz + pv[2, 3]
        cw = pv[3, 0] * wx + pv[3, 1] * wy + pv[3, 2] * wz + pv[3, 3]
        if not np.all(cw > 1e-6):
            return False, None
        zs.append(cz / cw)
        xs.append(cx / cw)
        ys.append(cy / cw)
    z = np.stack(zs)
    x = np.stack(xs)
    y = np.stack(ys)
    m = margin
    excluded = ((z > 1.0 + m).all(0) | (z < 0.0 - m).all(0)
                | (x > 1.0 + m).all(0) | (x < -1.0 - m).all(0)
                | (y > 1.0 + m).all(0) | (y < -1.0 - m).all(0))
    return bool(np.all(excluded)), (x, y)


def _cap_grid(grid, T: int):
    """Scene-sized pair caps for a bin grid (the JAX package's sizing:
    med_cap from T, pair_cap = min(4T + med_cap*med_slots,
    max(2T, 262144)) rounded up to the chunk)."""
    med_cap = max(2048, min(T // 32, 4096))
    want = min(4 * T + med_cap * grid.med_slots, max(2 * T, 262144))
    want = -(-want // grid.chunk) * grid.chunk
    return dataclasses.replace(grid, pair_cap=want, med_cap=med_cap)


def _with_proof(plan, pos, ent, model_mats, sun: SunInfo | None):
    """`plan` with the sun-shadow proof (_prove_shadow) of the triangle
    stream `pos`, `ent` (host arrays) under `model_mats` and `sun` (None:
    the default sun)."""
    sun_pv = (sun if sun is not None else SunInfo.create()
              ).projection_view.cpu().numpy()
    empty, proved, crop = _prove_shadow(
        pos, ent, model_mats, sun_pv,
        shadow_resolution=plan.config.shadow_resolution)
    return dataclasses.replace(
        plan, shadow_statically_empty=empty, proved_sun_pv=proved,
        shadow_crop=crop,
        proved_crop_mats=(tuple(float(v) for v in model_mats.ravel())
                          if crop is not None else None))


def _finish(scene: Scene, models, config: RenderConfig, camera_pos,
            camera_target, animate: bool = False, atlas_size: int = 1024,
            sun: SunInfo | None = None, ssr_cap: int | None = None,
            device=None) -> BuiltScene:
    """Pack `models` (one per mesh entity of `scene`, creation order)
    and prove the plan — the JAX package's scenes._finish.  ssr_cap:
    FramePlan.ssr_cap where enable_ssr; None sizes it as the JAX package
    does.  `device`: default the CUDA card (raises without one unless
    "cpu")."""
    device = resolve_device(device)
    lights = scene.update(0.0)
    config = config.replace(max_point_lights=int(lights.point_count),
                            max_spot_lights=int(lights.spot_count))
    with trace.span("scenes.pack"):
        batch, atlas = build_scene_batch(models, atlas_size=atlas_size,
                                         device=device)
    # the reference's tiled cloud-noise texture (cloud_rendering.inl:
    # 219-233), K6's input; without it the procedural sky LUT (K6p) runs
    noise_path = os.path.join(ASSETS, "Clouds/noise.png")
    if config.enable_clouds and os.path.exists(noise_path):
        with trace.span("scenes.noise"):
            with open(noise_path, "rb") as f:
                img = decode_image(f.read())
            batch = dataclasses.replace(batch, cloud_noise=torch.from_numpy(
                img[..., 0].astype(np.float32) / 255.0).to(device))
    with trace.span("scenes.prove"):
        plan = frame_mod.FramePlan.create(config, atlas)
        T = batch.num_triangles
        plan = dataclasses.replace(
            plan, main_grid=_cap_grid(plan.main_grid, T),
            shadow_grid=_cap_grid(plan.shadow_grid, T))
        mm, nm = scene.transform_matrices()
        plan = _with_proof(plan, batch.tri_pos.cpu().numpy(),
                           batch.tri_entity.cpu().numpy(), mm, sun)
        if config.enable_ssr:
            # the SSR march takes the first `ssr_cap` reflective pixels:
            # by default 5% of the screen, rounded up to 1,024 (the JAX
            # package's sizing); past it, OVERFLOW_SSR_CAP is set and the
            # rays over the cap go black
            scap = ssr_cap if ssr_cap is not None else -(
                -int(0.05 * config.width * config.height) // 1024) * 1024
            plan = dataclasses.replace(plan, ssr_cap=scap)
    cam = Camera3D()
    cam.resize(config.width, config.height)
    bs = BuiltScene(scene=scene, batch=batch, plan=plan, camera=cam,
                    camera_position=np.asarray(camera_pos, np.float32),
                    camera_target=np.asarray(camera_target, np.float32),
                    device=device, animate=animate, sun=sun,
                    ssr_cap=ssr_cap)
    bs._models = list(models)        # the models packed (strong refs)
    return bs


_DEFAULT_MODELS: dict = {}


def helmet_path() -> str:
    return os.path.join(ASSETS, "DamagedHelmet/glTF/DamagedHelmet.gltf")


def default_model():
    """The DamagedHelmet ModelData, loaded once per path (what a created
    entity's MeshComponent takes, application.cpp:22-28)."""
    path = helmet_path()
    if path not in _DEFAULT_MODELS:
        _DEFAULT_MODELS[path] = gltf.load_model(path)
    return _DEFAULT_MODELS[path]


def _entity(scene, name, model, position=None, scale=None):
    """A mesh entity of `scene` with a TRS transform."""
    e = scene.create_entity(name)
    tc = e.add_component(TransformComponent())
    if scale is not None:
        tc.set_scale(scale)
    if position is not None:
        tc.set_position(position)
    e.add_component(MeshComponent()).model = model
    return model


def build_helmet(config: RenderConfig, device=None, **kw) -> BuiltScene:
    """BASELINE config 1/2: DamagedHelmet (application.cpp:22-28)."""
    device = resolve_device(device)
    scene = Scene("helmet")
    with trace.span("scenes.models"):
        model = _entity(scene, "damaged helmet model",
                        gltf.load_model(helmet_path()))
    return _finish(scene, [model], config, camera_pos=[0.0, 0.0, 2.5],
                   camera_target=[0, 0, 0], device=device, **kw)


def build_helmet_lifted(config: RenderConfig, device=None,
                        **kw) -> BuiltScene:
    """The helmet lifted to y = 32, inside the sun's ortho volume (y
    24..56 around the y = 40 light, renderer.cpp:110-112), so the 4096^2
    shadow raster is not elidable and its cost is paid."""
    device = resolve_device(device)
    scene = Scene("helmet_lifted")
    with trace.span("scenes.models"):
        model = _entity(scene, "damaged helmet model",
                        gltf.load_model(helmet_path()),
                        position=[0.0, 32.0, 0.0])
    built = _finish(scene, [model], config, camera_pos=[0.0, 32.0, 2.5],
                    camera_target=[0, 32, 0], device=device, **kw)
    if built.plan.shadow_statically_empty:
        raise AssertionError("lifted helmet must defeat the elision proof")
    return built


def build_sponza(config: RenderConfig, device=None, **kw) -> BuiltScene:
    """BASELINE config 3/5 stand-in: the procedural atrium with Sponza's
    materials at scale 0.01 plus the DamagedHelmet (application.cpp:
    14-28's two-entity layout)."""
    device = resolve_device(device)
    scene = Scene("sponza")
    with trace.span("scenes.models"):
        atrium = _entity(scene, "sponza model", proc.build_atrium(
            texture_dir=os.path.join(ASSETS, "Sponza/glTF")),
            scale=[0.01] * 3)
        helmet = _entity(scene, "damaged helmet model",
                         gltf.load_model(helmet_path()))
    return _finish(scene, [atrium, helmet], config,
                   camera_pos=[-7.0, 1.8, 0.0], camera_target=[0, 1.5, 0],
                   device=device, **kw)


def build_sponza_lifted(config: RenderConfig, device=None,
                        **kw) -> BuiltScene:
    """``sponza``'s two entities lifted to y = 32, inside the sun's ortho
    volume (y 24..56 around the y = 40 light, renderer.cpp:104-133), with
    ``full``'s animated camera lifted alike: the 4096^2 shadow raster
    (K4) runs every frame and composition samples it through the proved
    crop.  Lifting the scene 32 puts the same geometry under the same
    shadow texels as lowering the default sun 32."""
    device = resolve_device(device)
    scene = Scene("sponza_lifted")
    with trace.span("scenes.models"):
        atrium = _entity(scene, "sponza model", proc.build_atrium(
            texture_dir=os.path.join(ASSETS, "Sponza/glTF")),
            position=[0.0, 32.0, 0.0], scale=[0.01] * 3)
        helmet = _entity(scene, "damaged helmet model",
                         gltf.load_model(helmet_path()),
                         position=[0.0, 32.0, 0.0])
    built = _finish(scene, [atrium, helmet], config,
                    camera_pos=[-7.0, 33.8, 0.0],
                    camera_target=[0, 33.5, 0], animate=True,
                    device=device, **kw)
    if built.plan.shadow_statically_empty:
        raise AssertionError("lifted sponza must defeat the elision proof")
    if built.plan.shadow_crop is None:
        raise AssertionError("lifted sponza must prove a shadow crop")
    return built


def _terrain_model(**build_kw):
    """The terrain preset's model: the heightmap of
    ``SOC_TERRAIN_HEIGHTMAP`` (EXR or PNG, R channel) or a procedural
    512^2 one, the albedo of ``SOC_TERRAIN_ALBEDO`` (EXR or an 8-bit
    image) or the height/slope colouring; build_kw: build_terrain_model
    overrides (height_scale, midpoint, scale, tess_level, ...)."""
    from .models import terrain as terrain_mod
    hm = terrain_mod.load_heightmap(os.environ.get("SOC_TERRAIN_HEIGHTMAP"),
                                    n=512)
    alb_path = os.environ.get("SOC_TERRAIN_ALBEDO")
    if alb_path:
        if alb_path.endswith(".exr"):
            from .utils import exr
            alb = exr.read_exr_rgba(alb_path)
        else:
            with open(alb_path, "rb") as f:
                alb = decode_image(f.read()).astype(np.float32) / 255.0
    else:
        alb = terrain_mod.default_albedo(hm)
    return terrain_mod.build_terrain_model(hm, alb, **build_kw)


def build_terrain(config: RenderConfig, device=None, **kw) -> BuiltScene:
    """BASELINE config 4: terrain + (elided) shadow + atmosphere sky."""
    device = resolve_device(device)
    scene = Scene("terrain")
    with trace.span("scenes.models"):
        model = _entity(scene, "terrain", _terrain_model())
    return _finish(scene, [model], config, camera_pos=[20.0, 12.0, 20.0],
                   camera_target=[50, 0, 50], device=device, **kw)


def _full_scene(name: str):
    """``full``'s scene: the atrium, the helmet and the terrain at y = -8;
    returns (scene, models)."""
    scene = Scene(name)
    with trace.span("scenes.models"):
        atrium = _entity(scene, "sponza model", proc.build_atrium(
            texture_dir=os.path.join(ASSETS, "Sponza/glTF")),
            scale=[0.01] * 3)
        helmet = _entity(scene, "damaged helmet model",
                         gltf.load_model(helmet_path()))
        terrain = _entity(scene, "terrain", _terrain_model(),
                          position=[0.0, -8.0, 0.0])
    return scene, [atrium, helmet, terrain]


def build_full(config: RenderConfig, device=None, **kw) -> BuiltScene:
    """BASELINE config 5: atrium + helmet + terrain at y = -8, animated
    camera."""
    device = resolve_device(device)
    scene, models = _full_scene("full")
    return _finish(scene, models, config, camera_pos=[-7.0, 1.8, 0.0],
                   camera_target=[0, 1.5, 0], animate=True, device=device,
                   **kw)


def full_lit_lights() -> dict:
    """The lit atrium's lights, in the schema of a benchmark
    configuration's ``lights``: ``{"point": [{position, color,
    intensity}], "spot": [{position, rotation_deg, color, intensity,
    cut_off_deg, outer_cut_off_deg}]}``, filling the globals' 128 point
    and 128 spot slots (shared.inl:84-85) inside the 24 x 12 x 9 m atrium
    of ``proc.build_atrium``.

    Point lights: 4 rows at z = -4.5, -1.5, 1.5, 4.5 of 32 each at
    x = -11.625 + 0.75 i, y = 0.8 (even i) or 2.4 (odd i).  Spot lights:
    2 rows at z = -3 and 3, along the colonnades, of 64 each at
    x = -11.8125 + 0.375 j, y = 7, pointing down and tilted 25 degrees
    toward the centre aisle (z = 0).  Intensity and cut-offs are the
    components' defaults (components.hpp:57: 16, 20 and 30 degrees);
    the colours are drawn in [0.3, 1]^3 from default_rng(21), points
    first, and kept as float32 values, so that a light shaded from
    another slot shows."""
    rng = np.random.default_rng(21)

    def colour():
        return [float(v) for v in rng.uniform(0.3, 1.0, 3).astype(
            np.float32)]

    pt, sp = PointLightComponent(), SpotLightComponent()
    point = [{"position": [-11.625 + 0.75 * i, 0.8 if i % 2 == 0 else 2.4,
                           z],
              "color": colour(), "intensity": pt.intensity}
             for z in (-4.5, -1.5, 1.5, 4.5) for i in range(32)]
    # rotate_x(+a) turns (0, -1, 0) toward -z: the z = 3 row leans by +25
    spot = [{"position": [-11.8125 + 0.375 * j, 7.0, z],
             "rotation_deg": [25.0 if z > 0 else -25.0, 0.0, 0.0],
             "color": colour(), "intensity": sp.intensity,
             "cut_off_deg": sp.cut_off, "outer_cut_off_deg": sp.outer_cut_off}
            for z in (-3.0, 3.0) for j in range(64)]
    return {"point": point, "spot": spot}


def add_lights(scene: Scene, spec: dict) -> None:
    """One entity with a transform and a light component for each light
    of `spec` (:func:`full_lit_lights`' schema), points first, in order:
    the order ``Scene.update`` gathers them into the slots."""
    for i, p in enumerate(spec.get("point", [])):
        e = scene.create_entity(f"point light {i}")
        e.add_component(TransformComponent()).set_position(p["position"])
        e.add_component(PointLightComponent(
            color=np.asarray(p["color"], np.float32),
            intensity=float(p["intensity"])))
    for i, s in enumerate(spec.get("spot", [])):
        e = scene.create_entity(f"spot light {i}")
        tc = e.add_component(TransformComponent())
        tc.set_position(s["position"])
        tc.set_rotation(s["rotation_deg"])
        e.add_component(SpotLightComponent(
            color=np.asarray(s["color"], np.float32),
            intensity=float(s["intensity"]),
            cut_off=float(s["cut_off_deg"]),
            outer_cut_off=float(s["outer_cut_off_deg"])))


def build_full_lit(config: RenderConfig, device=None, **kw) -> BuiltScene:
    """The lit atrium: ``full``'s entities and animated camera with the
    256 lights of :func:`full_lit_lights`, so _finish binds 128 point and
    128 spot lights and composition shades every pixel by each (K7 on
    the card)."""
    device = resolve_device(device)
    scene, models = _full_scene("full_lit")
    add_lights(scene, full_lit_lights())
    return _finish(scene, models, config, camera_pos=[-7.0, 1.8, 0.0],
                   camera_target=[0, 1.5, 0], animate=True, device=device,
                   **kw)


def polish_floor(atrium) -> None:
    """Make the floor of ``proc.build_atrium``'s model (material 0)
    polished tiles, in place: it keeps its albedo and normal maps and
    takes ``proc.metal_tile_image`` as its metallic-roughness map (8 x
    8-texel tiles, roughness 0.1-0.5, metallic ~0.9, a quarter of the
    tiles dielectric stone), appended to the model's images and packed
    into the atlas as any material map is."""
    atrium.images = [*atrium.images, proc.metal_tile_image()]
    atrium.materials[0] = dataclasses.replace(
        atrium.materials[0],
        metallic_roughness_image=len(atrium.images) - 1)


def build_full_ssr(config: RenderConfig, device=None, **kw) -> BuiltScene:
    """The reflective atrium: ``full``'s entities and animated camera with
    the atrium's floor polished (:func:`polish_floor`).  The floor can
    fill any share of the screen, so the SSR cap is the screen's pixel
    count: no reflective pixel is dropped and OVERFLOW_SSR_CAP cannot be
    set."""
    device = resolve_device(device)
    scene, models = _full_scene("full_ssr")
    polish_floor(models[0])
    kw.setdefault("ssr_cap", config.width * config.height)
    return _finish(scene, models, config, camera_pos=[-7.0, 1.8, 0.0],
                   camera_target=[0, 1.5, 0], animate=True, device=device,
                   **kw)


PRESETS = {"helmet": build_helmet, "helmet_lifted": build_helmet_lifted,
           "sponza": build_sponza, "sponza_lifted": build_sponza_lifted,
           "terrain": build_terrain, "full": build_full,
           "full_lit": build_full_lit, "full_ssr": build_full_ssr}


def build(name: str, config: RenderConfig, device=None, **kw) -> BuiltScene:
    """The preset `name` (one of PRESETS: ``helmet``, ``helmet_lifted``,
    ``sponza``, ``sponza_lifted``, ``terrain``, ``full``, ``full_lit``,
    ``full_ssr``); kw passes through to _finish (atlas_size, sun,
    ssr_cap)."""
    if name not in PRESETS:
        raise ValueError(name)
    with trace.span("scenes.build"):
        return PRESETS[name](config, device=device, **kw)
