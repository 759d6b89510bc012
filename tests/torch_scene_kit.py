"""Shared scene composition for the port's multi-entity tests: the same
scenes composed from ``Scene`` + ``_finish`` in the JAX package and in the
port.

* ``small_atrium``: the atrium's layout (floor, ceiling, walls, columns,
  crates; five flat materials; Sponza pre-scale units) at a coarse
  subdivision, ~1.3k triangles instead of 153k, so that the JAX
  package's interpret-mode resolves stay quick.  Both packages build it
  from the same ``proc.subdivide_quad`` / ``proc._cylinder`` /
  ``proc._box`` arrays (the full atrium is held byte-identical on its
  own in test_torch_scene.py).
* ``full_nohelmet``: the JAX ``build_full`` without its helmet — the
  atrium at scale 0.01 plus the terrain at y = -8, camera (-7, 1.8, 0)
  -> (0, 1.5, 0), animated.
* ``atrium_lifted``: the JAX ``build_helmet_lifted`` with the atrium in
  the helmet's place — scale 0.01 at y = 32, inside the sun's ortho
  volume, so the shadow map is rastered; camera (-7, 33.8, 0) ->
  (0, 33.5, 0).
* ``atrium_passes``: ``atrium_lifted`` with a metallic floor (material 0
  takes ``metal_image``, a metallic-roughness image made from a seed),
  so that SSR has pixels to march; ``terrain_perpixel``: the reduced
  terrain alone with the cloud-noise field, whose camera sees sky, for
  the per-pixel cloud march.
* ``cloud_noise``: the synthetic (64, 64) tiled noise field of
  tests/test_sky_pallas.py (the shape class of assets/Clouds/noise.png).

The JAX package is imported only inside the functions that build its
side, so the port-only tests (tests/test_torch_cuda.py) can use this
module where jax is not installed.

Importing this module gives each pytest-xdist worker its share of the
cores for torch's intra-op pool: ``os.cpu_count()`` over
``PYTEST_XDIST_WORKER_COUNT``, at least one thread.  Every worker
collects every test module, and most of the port's import this one, so
the share is set in each worker before its first test.  Without it
each of n workers runs torch at one thread a core, n times more threads
than cores, and a frame test that takes 22 s alone took 531 s among six
workers.  Outside xdist torch keeps its default.
"""
import dataclasses
import os

import numpy as np
import torch

from soc_real_time_renderer_tpu_torch import scenes as pscenes
from soc_real_time_renderer_tpu_torch.models import gltf as pgltf
from soc_real_time_renderer_tpu_torch.models import proc as pproc
from soc_real_time_renderer_tpu_torch.models import terrain as pterrain
from soc_real_time_renderer_tpu_torch.scene import components as pcomp
from soc_real_time_renderer_tpu_torch.scene.scene import Scene as PScene

if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
        os.environ["PYTEST_XDIST_WORKER_COUNT"])))

SCENES = {
    "full_nohelmet": dict(camera_pos=[-7.0, 1.8, 0.0],
                          camera_target=[0, 1.5, 0], animate=True),
    "atrium_lifted": dict(camera_pos=[-7.0, 33.8, 0.0],
                          camera_target=[0, 33.5, 0]),
}
# the scenes of the passes that are off by default (not in SCENES: the
# two-frame slices of test_torch_scenes.py iterate over it)
PASS_SCENES = {
    "atrium_passes": SCENES["atrium_lifted"],
    "terrain_perpixel": dict(camera_pos=[20.0, 12.0, 20.0],
                             camera_target=[50, 0, 50]),
}


def metal_image(seed=5, size=64):
    """(size, size, 4) uint8 metallic-roughness image (glTF channels:
    G roughness, B metallic): the port's tile map of the ``full_ssr``
    floor (``proc.metal_tile_image``), roughness in [0.1, 0.5], metallic
    ~0.9 with a quarter of the tiles dielectric."""
    return pproc.metal_tile_image(seed, size)


# the lifted atrium's column sliver under the default sun (clip space,
# orthographic: w = 1): in the 4096^2 map its float32 edge functions all
# pass at texels (1971, 2190) and (1971, 2191), past its box's last row
LIFTED_SLIVER = [[float.fromhex(v) for v in vertex] for vertex in (
    ("-0x1.3236c8p-5", "0x1.19e29p-4", "0x1.0d959p-1"),
    ("-0x1.333338p-5", "0x1.0c7508p-4", "0x1.0a934cp-1"),
    ("-0x1.3236c8p-5", "0x1.16784p-4", "0x1.0a8818p-1"))]


def sliver_clip():
    """(3, 4, 1) planar clip positions of LIFTED_SLIVER."""
    return torch.tensor([[*v, 1.0] for v in LIFTED_SLIVER]).reshape(3, 4, 1)


def cloud_noise():
    """tests/test_sky_pallas.py's smooth tiled (64, 64) field."""
    rng = np.random.default_rng(11)
    base = rng.random((16, 16)).astype(np.float32)
    up = np.kron(base, np.ones((4, 4), np.float32))
    k = np.ones((3, 3), np.float32) / 9.0
    sm = up.copy()
    for _ in range(2):
        padded = np.pad(sm, 1, mode="wrap")
        sm = sum(padded[dy:dy + 64, dx:dx + 64] * k[dy, dx]
                 for dy in range(3) for dx in range(3))
    return sm.astype(np.float32)


def small_atrium_groups(proc):
    """[(quads, material)] of a coarse atrium from `proc`'s primitives."""
    L, W, H = 2400.0, 1200.0, 900.0
    sq = proc.subdivide_quad
    floor = sq([-L / 2, 0, W / 2], [L / 2, 0, W / 2], [L / 2, 0, -W / 2],
               [-L / 2, 0, -W / 2], 12, 6)
    ceil_q = sq([-L / 2, H, -W / 2], [L / 2, H, -W / 2], [L / 2, H, W / 2],
                [-L / 2, H, W / 2], 12, 6)
    walls = np.concatenate([
        sq([-L / 2, H, -W / 2], [-L / 2, H, W / 2], [-L / 2, 0, W / 2],
           [-L / 2, 0, -W / 2], 6, 4),
        sq([L / 2, H, W / 2], [L / 2, H, -W / 2], [L / 2, 0, -W / 2],
           [L / 2, 0, W / 2], 6, 4),
        sq([-L / 2, H, W / 2], [L / 2, H, W / 2], [L / 2, 0, W / 2],
           [-L / 2, 0, W / 2], 12, 4),
        sq([L / 2, H, -W / 2], [-L / 2, H, -W / 2], [-L / 2, 0, -W / 2],
           [L / 2, 0, -W / 2], 12, 4)])
    cols = []
    for row_z in (-W / 4, W / 4):
        for i in range(4):
            x = -L / 2 + (i + 0.5) * L / 4
            cols += proc._cylinder((x, 0.0, row_z), 40.0, H * 0.85,
                                   segments=12, vdiv=4)
    crates = np.concatenate([sq(*q, 2, 2) for cx, cz in
                             ((-400.0, 100.0), (300.0, -150.0))
                             for q in proc._box(cx, cz, 60.0, 120.0)])
    return [(floor, 0), (ceil_q, 1), (walls, 2), (np.asarray(cols), 3),
            (crates, 4)]


def _metal_floor(model, material_cls, image):
    """`model` with material 0 (the floor) taking `image` as its
    metallic-roughness image."""
    model.images = [image]
    model.materials[0] = material_cls(metallic_roughness_image=0)
    return model


def _png_bytes(img):
    """`img` (H, W, 4) uint8 as PNG bytes: the JAX package's models hold
    encoded images (the port's hold decoded ones)."""
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img, "RGBA").save(buf, format="PNG")
    return buf.getvalue()


def small_atrium_jax(metal_floor=False):
    """The JAX package's ModelData of small_atrium_groups (the body of
    its build_atrium after the geometry)."""
    from soc_real_time_renderer_tpu.models import gltf as jgltf
    from soc_real_time_renderer_tpu.models import proc as jproc
    pos_l, nrm_l, uv_l, idx_l, prims = [], [], [], [], []
    voff = ioff = 0
    for quads, mat in small_atrium_groups(jproc):
        p, n, u, ix = jproc._mesh_from_quads(quads, uv_scale=1 / 300.0)
        pos_l.append(p)
        nrm_l.append(n)
        uv_l.append(u)
        idx_l.append(ix + voff)
        prims.append(jgltf.PrimitiveRange(
            first_index=ioff, first_vertex=voff, index_count=len(ix),
            vertex_count=len(p), material_index=mat))
        voff += len(p)
        ioff += len(ix)
    model = jgltf.ModelData(
        positions=np.concatenate(pos_l), normals=np.concatenate(nrm_l),
        uvs=np.concatenate(uv_l), tangents=np.zeros((voff, 4), np.float32),
        indices=np.concatenate(idx_l).astype(np.uint32), primitives=prims,
        materials=[jgltf.MaterialData() for _ in range(5)], images=[])
    if metal_floor:
        _metal_floor(model, jgltf.MaterialData, jgltf.ImageRef(
            "floor_metal", _png_bytes(metal_image())))
    return model


def small_atrium_port(metal_floor=False):
    model = pproc.model_from_groups(
        small_atrium_groups(pproc), [pgltf.MaterialData() for _ in range(5)])
    if metal_floor:
        _metal_floor(model, pgltf.MaterialData, metal_image())
    return model


def small_tree(root):
    """The small synthetic asset tree at `root` (tools/synth_assets.py:
    a 500-triangle helmet with five 64^2 maps, a 64^2 Clouds/noise.png,
    no Sponza); returns the path."""
    from soc_real_time_renderer_tpu_torch.tools import synth_assets
    synth_assets.write_asset_tree(str(root), rings=10, segments=25,
                                  helmet_map=64, sponza=False)
    return str(root)


def point_both_at(mp, tree):
    """With monkeypatch `mp`: both packages' scenes.ASSETS at `tree`,
    their terrain the reduced one (re-bake overrides honoured), the JAX
    default model unloaded."""
    from soc_real_time_renderer_tpu import scenes as jscenes
    mp.setattr(jscenes, "ASSETS", tree)
    mp.setattr(pscenes, "ASSETS", tree)
    mp.setattr(jscenes, "_DEFAULT_MODEL", None)
    mp.setattr(jscenes, "_terrain_model",
               lambda **kw: small_terrain("jax", **kw))
    mp.setattr(pscenes, "_terrain_model",
               lambda **kw: small_terrain("port", **kw))


def small_terrain(pkg, **build_kw):
    """The reduced terrain: 64^2 heightmap, tess level 1; build_kw:
    build_terrain_model overrides (the viewer's re-bake passes
    height_scale, midpoint, scale)."""
    if pkg == "jax":
        from soc_real_time_renderer_tpu.models import terrain as mod
    else:
        mod = pterrain
    hm = mod.procedural_heightmap(64)
    return mod.build_terrain_model(hm, mod.default_albedo(hm),
                                   **{"tess_level": 1, **build_kw})


def entities(name, atrium, terrain=None, atrium_scale=0.01):
    """[(entity name, model, position, scale)] of scene `name`."""
    if name == "terrain_perpixel":
        return [("terrain", terrain, None, None)]
    if name == "full_nohelmet":
        return [("sponza model", atrium, None, [atrium_scale] * 3),
                ("terrain", terrain, [0.0, -8.0, 0.0], None)]
    return [("sponza model", atrium, [0.0, 32.0, 0.0], [atrium_scale] * 3)]


def make_scene(pkg, ents):
    if pkg == "jax":
        from soc_real_time_renderer_tpu.scene import components as comps
        from soc_real_time_renderer_tpu.scene.scene import Scene
    else:
        Scene, comps = PScene, pcomp
    scene = Scene("scene")
    for ename, model, pos, scale in ents:
        e = scene.create_entity(ename)
        tc = e.add_component(comps.TransformComponent())
        if scale is not None:
            tc.set_scale(scale)
        if pos is not None:
            tc.set_position(pos)
        e.add_component(comps.MeshComponent()).model = model
    return scene


def _entities_of(pkg, name, atrium_scale):
    atrium = small_atrium_jax if pkg == "jax" else small_atrium_port
    terrain = (small_terrain(pkg)
               if name in ("full_nohelmet", "terrain_perpixel") else None)
    return entities(name, atrium(metal_floor=name == "atrium_passes"),
                    terrain, atrium_scale)


def build_port(name, cfg, device, *, atrium_scale=0.01, atlas_size=64,
               noise=True):
    """The port's BuiltScene of scene `name` with the small atrium (and
    the small terrain), with the cloud noise field when `noise`."""
    ents = _entities_of("port", name, atrium_scale)
    b = pscenes._finish(make_scene("port", ents), [m for _, m, _, _ in ents],
                        cfg, atlas_size=atlas_size, device=device,
                        **{**SCENES, **PASS_SCENES}[name])
    if noise:
        b.batch = dataclasses.replace(
            b.batch, cloud_noise=torch.from_numpy(cloud_noise()).to(device))
    return b


def build_jax(name, cfg, *, atrium_scale=0.01, atlas_size=64, noise=True):
    """The JAX package's BuiltScene of scene `name`, as build_port."""
    import jax.numpy as jnp
    from soc_real_time_renderer_tpu import scenes as jscenes
    ents = _entities_of("jax", name, atrium_scale)
    jb = jscenes._finish(make_scene("jax", ents), [m for _, m, _, _ in ents],
                         cfg, atlas_size=atlas_size,
                         **{**SCENES, **PASS_SCENES}[name])
    if noise:
        jb.batch = dataclasses.replace(
            jb.batch, cloud_noise=jnp.asarray(cloud_noise()))
    return jb


def build_pair(name, jcfg_obj, pcfg_obj, *, atrium_scale=0.01,
               atlas_size=64, noise=True):
    """(JAX BuiltScene, port BuiltScene on the CPU) of the same scene."""
    kw = dict(atrium_scale=atrium_scale, atlas_size=atlas_size, noise=noise)
    return (build_jax(name, jcfg_obj, **kw),
            build_port(name, pcfg_obj, "cpu", **kw))
