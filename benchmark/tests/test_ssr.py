"""The reference's screen-space reflections (``reference/ssr.py``) and
how the harness holds a configuration with ``enable_ssr`` to them.

- The march against a scalar loop per ray written from the shader's
  description, with an early return at the hit, on a hand-built 16x8
  view: a mirror floor, a wall, the sky and one dielectric pixel.
- The reference against the port's ``ops/ssr.ssr``, dense and
  compacted, and the harness's check (one view, the batched step, the
  bf16 control, an altered reflection) on a reduced atrium frame: the
  atrium of ``tests/torch_scene_kit.py`` with its metallic floor, as
  ``atrium_passes`` has it, seen from above at 128x64, where the
  ceiling faces away and is culled, so that rays that leave through it
  find the sky and miss.
- Without ``enable_ssr`` the reference makes no ``ssr`` and the
  roofline no ``ssr_march``, and what the harness hands it for SSR
  changes none of its outputs (the reduced terrain and atrium frames).
- ``check.compare``'s ``ssr`` number and the order of ``NUMBERS``.

On the CPU, through the port's plain versions."""
import dataclasses
import os
import sys
import types

import numpy as np
import pytest
import torch

from benchmark import check, harness, registry, roofline
from benchmark import spans as spans_mod
from benchmark.reference import frame as ref_frame
from benchmark.reference import mathutil as mu
from benchmark.reference import ssr as ref_ssr
from benchmark.reference.composition import view_from_depth
from benchmark.reference.globals import RenderConfig as RefConfig
from benchmark.reference.sampling import grid_uv
from benchmark.reference.vec import mat_vec3, normalize3
from benchmark.traffic import Traffic

sys.path.insert(0, os.path.join(registry.ROOT, "tests"))
import torch_scene_kit as kit  # noqa: E402

SEED = 2 ** 31 + 2323
CPU = torch.device("cpu")
F = np.float32
W, H = 128, 64
# the lifted atrium (y 32 to 41) seen from above its ceiling
CAMERA = {"position": [-3.0, 46.0, -9.0], "target": [0.0, 32.0, 0.0]}
ORBIT = {"camera": "orbit", "start_frame": [1, 10000]}
PARENT_NUMBERS = ("globals", "tri_id", "depth", "gbuffer", "bloom", "ssao",
                  "sky_lut", "clouds", "hdr", "exposure", "history",
                  "color")


# ---- (a) the march against a scalar loop per ray

def _hand_view():
    """(depth (8, 16), albedo, normal (3, 8, 16), metallic_roughness
    (2, 8, 16), globals) of a camera at the origin looking down -z
    (view = identity): a mirror floor at y = -1, a dielectric wall at
    z = -6 left of x = 1.5, the sky (depth 1) elsewhere, and one floor
    pixel dielectric."""
    hh, ww = 8, 16
    proj = mu.perspective(90.0, ww / hh, 0.1, 1000.0)
    inv = np.linalg.inv(proj.astype(np.float64))
    depth = np.ones((hh, ww), np.float64)
    albedo = np.zeros((3, hh, ww), np.float64)
    normal = np.zeros((3, hh, ww), np.float64)
    mr = np.zeros((2, hh, ww), np.float64)
    for j in range(hh):
        for i in range(ww):
            ndc = np.array([2 * (i + 0.5) / ww - 1, 2 * (j + 0.5) / hh - 1,
                            0.5, 1.0])
            d = inv @ ndc
            d = d[:3] / d[3]                       # a point on the ray
            hits = []
            if d[1] < 0:
                hits.append((-1.0 / d[1], "floor"))
            if d[2] < 0 and (-6.0 / d[2]) * d[0] < 1.5:
                hits.append((-6.0 / d[2], "wall"))
            if not hits:
                continue
            t, what = min(hits)
            p = d * t
            clip = proj.astype(np.float64) @ np.append(p, 1.0)
            depth[j, i] = clip[2] / clip[3]
            if what == "floor":
                albedo[:, j, i] = (0.2, 0.2, 0.25)
                normal[:, j, i] = (0.0, 1.0, 0.0)
                mr[:, j, i] = (0.0, 1.0)
            else:
                albedo[:, j, i] = (0.5 + 0.4 * np.sin(p[0]),
                                   0.3 + 0.3 * np.cos(p[1]), 0.7)
                normal[:, j, i] = (0.0, 0.0, 1.0)
    floor = np.argwhere(mr[1] == 1.0)
    mr[1][tuple(floor[len(floor) // 2])] = 0.0      # one dielectric pixel
    t32 = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    g = types.SimpleNamespace(camera=types.SimpleNamespace(
        projection=t32(proj), inv_projection=t32(np.linalg.inv(proj)),
        view=torch.eye(4)))
    return t32(depth), t32(albedo), t32(normal), t32(mr), g


def _bilinear(img, u, v):
    """One clamp-to-edge bilinear tap of (H, W) `img` at (u, v)."""
    hh, ww = img.shape

    def index(x, n):
        return int(min(max(np.nan_to_num(x, nan=-1.0), -1.0), n))

    x, y = u * F(ww) - F(0.5), v * F(hh) - F(0.5)
    x0 = min(max(index(np.floor(x), ww), 0), ww - 1)
    y0 = min(max(index(np.floor(y), hh), 0), hh - 1)
    x1, y1 = min(x0 + 1, ww - 1), min(y0 + 1, hh - 1)
    fx = min(max(x - F(x0), F(0)), F(1))
    fy = min(max(y - F(y0), F(0)), F(1))
    top = img[y0, x0] * (F(1) - fx) + img[y0, x1] * fx
    bot = img[y1, x0] * (F(1) - fx) + img[y1, x1] * fx
    return top * (F(1) - fy) + bot * fy


def _row(m, r, p, w=F(1)):
    return m[r, 0] * p[0] + m[r, 1] * p[1] + m[r, 2] * p[2] + m[r, 3] * w


def _view_pos(inv, u, v, d):
    ndc = (u * F(2) - F(1), v * F(2) - F(1), d)
    ws = _row(inv, 3, ndc)
    ws = ws if ws != 0 else F(1)
    return np.array([_row(inv, r, ndc) / ws for r in range(3)], F)


def _normalize(a):
    n = np.sqrt(max(a[0] * a[0] + a[1] * a[1] + a[2] * a[2], F(0)))
    return a / max(n, F(1e-8))


def _scalar_ray(depth, proj, inv, view, u, v, d, n):
    """(hit uv or None, probes) of the ray at pixel uv (u, v) of depth d
    with world normal n, as the shader marches it: step forward until
    the point passes behind the surface, then halve the step and move
    against the sign of the gap; return at the first |gap| < 0.05."""
    pos = _view_pos(inv, u, v, d)
    nv = _normalize(np.array([view[r, 0] * n[0] + view[r, 1] * n[1]
                              + view[r, 2] * n[2] for r in range(3)], F))
    d = pos[0] * nv[0] + pos[1] * nv[1] + pos[2] * nv[2]
    step = _normalize(pos - F(2) * d * nv) * F(0.5)
    point, refining = pos + step, False
    for i in range(50):
        w = _row(proj, 3, point)
        w = w if w != 0 else F(1)
        su = _row(proj, 0, point) / w * F(0.5) + F(0.5)
        sv = _row(proj, 1, point) / w * F(0.5) + F(0.5)
        z = _view_pos(inv, su, sv, _bilinear(depth, su, sv))[2]
        gap = abs(point[2]) - abs(z)
        if abs(gap) < F(0.05):
            return (su, sv), i + 1
        refining = refining or gap > 0
        if refining:
            step = step * F(0.5)
            point = point - step * np.sign(gap)
        else:
            point = point + step
            step = step * F(1.05)
    return None, 50


def test_the_march_agrees_with_a_scalar_loop_per_ray():
    depth, albedo, normal, mr, g = _hand_view()
    image, counts = ref_ssr.ssr(depth, albedo, normal, mr, g)
    proj, inv = g.camera.projection.numpy(), g.camera.inv_projection.numpy()
    view = g.camera.view.numpy()
    hh, ww = depth.shape
    dn, an = depth.numpy(), albedo.numpy()
    hits = misses = probes = 0
    for j in range(hh):
        for i in range(ww):
            u, v = F((i + 0.5) / ww), F((j + 0.5) / hh)
            if mr[1, j, i] < 0.01:
                assert torch.equal(image[:, j, i], albedo[:, j, i])
                continue
            uv, n = _scalar_ray(dn, proj, inv, view, u, v, dn[j, i],
                                normal[:, j, i].numpy())
            probes += n
            if uv is None:
                misses += 1
                assert torch.equal(image[:, j, i], torch.zeros(3)), (j, i)
                continue
            hits += 1
            want = [_bilinear(an[c], *uv) for c in range(3)]
            np.testing.assert_allclose(image[:, j, i].numpy(), want,
                                       atol=1e-6)
    # the march's hit uv, to 1e-6 of the loop's
    pos = view_from_depth(grid_uv(hh, ww), depth, g.camera.inv_projection)
    vn = normalize3(mat_vec3(g.camera.view[:3, :3], normal))
    r = ~(mr[1] < 0.01)
    found, uv, n = ref_ssr.march(pos[:, r], vn[:, r], depth,
                                 g.camera.projection, g.camera.inv_projection)
    for k, (j, i) in enumerate(torch.nonzero(r).tolist()):
        want, _ = _scalar_ray(dn, proj, inv, view, F((i + 0.5) / ww),
                              F((j + 0.5) / hh), dn[j, i],
                              normal[:, j, i].numpy())
        assert bool(found[k]) == (want is not None)
        if want is not None:
            assert abs(float(uv[0, k]) - want[0]) <= 1e-6
            assert abs(float(uv[1, k]) - want[1]) <= 1e-6
    assert hits > 0 and misses > 0 and (mr[1] == 0).any()
    assert counts == dict(pixels=hh * ww, rays=int(r.sum()), probes=probes)


# ---- the reduced atrium with its metallic floor, from above

@pytest.fixture(scope="module")
def reflective():
    """(configuration, BuiltScene, {views: (traffic, samples)}): full's
    configuration at 128x64 with SSR computed and composited, its
    camera above the lifted atrium; two steps of one view and of two,
    the second sampled."""
    from soc_real_time_renderer_tpu_torch import scenes
    from soc_real_time_renderer_tpu_torch.config import RenderConfig
    from soc_real_time_renderer_tpu_torch.graph import frame as fm
    rc = {"shadow_resolution": 256, "enable_ssr": True,
          "composite_ssr": True}
    cfg = registry.config("full_1080p")
    cfg.update(width=W, height=H, render_config=rc, camera=CAMERA)
    cfg["check"] = dict(cfg["check"], samples=1, within_frames=2,
                        limits=dict(cfg["check"]["limits"], ssr=0.0))
    torch.set_grad_enabled(False)
    model = kit.small_atrium_port(metal_floor=True)
    ents = kit.entities("atrium_passes", model)
    built = scenes._finish(
        kit.make_scene("port", ents), [model], RenderConfig(
            width=W, height=H, **rc), atlas_size=64, device=CPU,
        camera_pos=CAMERA["position"], camera_target=CAMERA["target"],
        animate=True)
    built.batch = dataclasses.replace(
        built.batch, cloud_noise=torch.from_numpy(kit.cloud_noise()))
    # _finish's cap (5% of the screen rounded up to 1,024) is under the
    # floor's reflective pixels here, which would set OVERFLOW_SSR_CAP:
    # the march takes the screen's size, as chip_smoke's passes do
    assert built.plan.ssr_cap == 1024
    built.plan = dataclasses.replace(built.plan, ssr_cap=W * H)
    sp = spans_mod.Spans()
    sp.install(fm)
    runs = {}
    try:
        for views in (1, 2):
            traffic = Traffic(dict(ORBIT, views=views), SEED)
            loop = harness.Loop(built, traffic, sp, harness.Clock(CPU))
            frames = [loop.frame(n) for n in range(2)]
            assert loop.raised == 0 and not loop.flags[:2].any()
            g, mm, nm = frames[1][:3]
            runs[views] = (traffic, [dict(
                k=1, g=g, mats=(mm, nm),
                targets=harness.targets_of(*frames[1][3:]))])
    finally:
        sp.uninstall()
    yield cfg, built, runs
    torch.set_grad_enabled(True)


def _program_frame(reflective):
    """(depth, albedo, normal, metallic_roughness, ssr, g) of the
    one-view step's sampled frame."""
    _, _, runs = reflective
    s = runs[1][1][0]
    t = s["targets"]
    return (t["depth"], t["albedo"], t["normal"], t["metallic_roughness"],
            t["ssr"], s["g"])


@pytest.mark.parametrize("compacted", [False, True],
                         ids=["dense", "compacted"])
def test_the_reference_equals_the_ports_ssr(reflective, compacted):
    """The port's plain SSR, dense (compact_cap 0) and compacted (a cap
    at the reflective pixels' count), reads an ssr share of 0 against
    the reference on a frame where rays both hit and miss; so does the
    frame's own ssr target."""
    from soc_real_time_renderer_tpu_torch.ops import ssr as port_ssr
    depth, albedo, normal, mr, frame_ssr, g = _program_frame(reflective)
    image, counts = ref_ssr.ssr(depth, albedo, normal, mr, g)
    rays = counts["rays"]
    assert 0 < rays < W * H
    out, overflow, active = port_ssr.ssr(depth, albedo, normal, mr, g,
                                         compact_cap=rays if compacted
                                         else 0)
    assert int(overflow) == 0 and int(active) == (rays if compacted else -1)
    assert check._flipped(out, image) == 0.0
    assert check._flipped(frame_ssr, image) == 0.0
    pos = view_from_depth(grid_uv(H, W), depth, g.camera.inv_projection)
    vn = normalize3(mat_vec3(g.camera.view[:3, :3], normal))
    r = ~(mr[1] < 0.01)
    found, _, probes = ref_ssr.march(pos[:, r], vn[:, r], depth,
                                     g.camera.projection,
                                     g.camera.inv_projection)
    assert 0 < int(found.sum()) < rays                # hits and misses
    assert int(probes.sum()) == counts["probes"]


def test_the_harness_checks_ssr_and_counts_the_march(reflective,
                                                     monkeypatch):
    """reference_check on the configuration naming enable_ssr and
    composite_ssr: an ssr number of 0 that its limit judges, every
    other number within full's limits, and the ssr_march job of the
    reference's pixels, rays and probes in the frame's jobs."""
    cfg, built, runs = reflective
    traffic, samples = runs[1]
    real, counts = ref_frame.render, []

    def spy(*a, **kw):
        out = real(*a, **kw)
        counts.append(out["counts"]["ssr"])
        return out

    monkeypatch.setattr(ref_frame, "render", spy)
    per_frame, jobs = harness.reference_check(cfg, built, traffic, samples,
                                              CPU, jobs=True)
    numbers = check.worst(per_frame)
    assert list(numbers)[-1] == "ssr" and numbers["ssr"] == 0.0
    ok, shown = check.judge(numbers, cfg["check"]["limits"])
    assert ok, shown
    assert shown["ssr"] == {"value": 0.0, "limit": 0.0}
    (c,) = counts
    assert c["pixels"] == W * H and 0 < c["rays"] < W * H
    assert c["rays"] <= c["probes"] <= 50 * c["rays"]
    assert jobs["ssr_march"] == roofline.bound_ms(*roofline.ssr_job(**c))


def test_the_batched_step_is_checked_per_view(reflective):
    """The two-view step hands out each view's own ssr: each reads 0."""
    cfg, built, runs = reflective
    traffic, samples = runs[2]
    assert samples[0]["targets"]["ssr"].shape == (2, 3, H, W)
    per_frame, _ = harness.reference_check(cfg, built, traffic, samples,
                                           CPU)
    assert len(per_frame) == 2
    assert [f["ssr"] for f in per_frame] == [0.0, 0.0]
    ok, shown = check.judge(check.worst(per_frame), cfg["check"]["limits"])
    assert ok, shown


def test_the_bf16_control_flips_rays(reflective):
    """The control (the reference in bfloat16, the march's inputs and
    image rounded) reads an ssr share above 0, and fails its limit."""
    cfg, built, runs = reflective
    traffic, samples = runs[1]
    per_frame, _ = harness.reference_check(cfg, built, traffic, samples,
                                           CPU, control=True)
    numbers = check.worst(per_frame)
    assert numbers["ssr"] > 0.0
    ok, shown = check.judge(numbers, {"ssr": 0.0})
    assert not ok and shown["ssr"]["value"] == numbers["ssr"]


def test_an_altered_reflection_is_not_correct(reflective):
    """One pixel of the program's ssr altered where it is produced: the
    ssr number reads 1 / (W·H) and fails its limit."""
    cfg, built, runs = reflective
    traffic, samples = runs[1]
    t = dict(samples[0]["targets"])
    ssr = t["ssr"].clone()
    ssr[..., 20, 30] += 0.25
    t["ssr"] = ssr
    per_frame, _ = harness.reference_check(
        cfg, built, traffic, [dict(samples[0], targets=t)], CPU)
    numbers = check.worst(per_frame)
    assert numbers["ssr"] == pytest.approx(1.0 / (W * H))
    assert not check.judge(numbers, cfg["check"]["limits"])[0]


# ---- (d) without SSR nothing changes

@pytest.fixture(scope="module")
def plain_frames(tiny):
    """{scene: (configuration, BuiltScene, traffic, samples)} with SSR
    off: the tiny terrain cell and the reduced atrium (full_nohelmet at
    128x64), two frames each, the second sampled."""
    from soc_real_time_renderer_tpu_torch.config import RenderConfig
    from soc_real_time_renderer_tpu_torch.graph import frame as fm
    import json
    spec, base = tiny
    with open(f"{base}/configs/tiny_terrain.json") as f:
        terrain = json.load(f)
    atrium = registry.config("full_1080p")
    atrium.update(width=W, height=H, render_config={"shadow_resolution": 256})
    atrium["check"] = dict(atrium["check"], samples=1, within_frames=2)
    torch.set_grad_enabled(False)
    dev = harness.prepare(dict(registry.cell(spec, "tiny.fly"), chips=1),
                          terrain, "cpu")
    builds = {"terrain": (terrain, harness.build_scene(terrain, dev), "fly"),
              "atrium": (atrium, kit.build_port(
                  "full_nohelmet", RenderConfig(width=W, height=H,
                                                shadow_resolution=256),
                  "cpu"), "orbit")}
    sp = spans_mod.Spans()
    sp.install(fm)
    out = {}
    try:
        for name, (cfg, built, mix) in builds.items():
            traffic = Traffic(registry.traffic(mix, base), SEED)
            loop = harness.Loop(built, traffic, sp, harness.Clock(CPU))
            frames = [loop.frame(n) for n in range(2)]
            assert loop.raised == 0 and not loop.flags[:2].any()
            g, mm, nm = frames[1][:3]
            out[name] = (cfg, built, traffic, [dict(
                k=1, g=g, mats=(mm, nm),
                targets=harness.targets_of(*frames[1][3:]))])
    finally:
        sp.uninstall()
    yield out
    torch.set_grad_enabled(True)


def _bits_equal(a, b) -> bool:
    """torch.equal of the bit patterns (a NaN equals itself: the sky
    LUT's rows below the horizon are NaN)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = (x.view(ints[x.element_size()]) for x in (a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("scene", ["terrain", "atrium"])
def test_without_ssr_the_reference_makes_none_and_ignores_its_inputs(
        plain_frames, monkeypatch, scene):
    """SSR off: the program hands out no ssr, the reference's frame has
    no ssr and no ssr counts, the jobs no ssr_march, and a G-buffer and
    an ssr image handed to the reference leave every output it makes
    equal, bit for bit, to a render without them."""
    cfg, built, traffic, samples = plain_frames[scene]
    assert "ssr" not in samples[0]["targets"]
    real, seen = ref_frame.render, []

    def spy(*a, gbuffer=None, ssr=None, **kw):
        given = real(*a, gbuffer=gbuffer,
                     ssr=gbuffer["albedo"] * 0.5 if ssr is None else ssr,
                     **kw)
        alone = real(*a, **kw)
        assert given.keys() == alone.keys() and "ssr" not in given
        assert "ssr" not in given["counts"]
        for k, v in alone.items():
            if isinstance(v, torch.Tensor):
                assert _bits_equal(given[k], v), k
        seen.append(scene)
        return given

    monkeypatch.setattr(ref_frame, "render", spy)
    per_frame, jobs = harness.reference_check(cfg, built, traffic, samples,
                                              CPU, jobs=True)
    assert seen == [scene]
    assert "ssr" not in per_frame[0]
    assert jobs and "ssr_march" not in jobs
    assert not RefConfig().enable_ssr and not RefConfig().composite_ssr


# ---- (e) the number

def _targets(ssr):
    n = ssr.shape[-2:]
    return {"globals": 0.0, "tri_id": torch.zeros(n, dtype=torch.int32),
            "depth": torch.zeros(n), "ssr": ssr}


@pytest.mark.parametrize("step, share", [(0.25, 1.0), (5e-4, 0.0),
                                         (float("nan"), 1.0)],
                         ids=["flipped", "round_off", "nan"])
def test_one_pixel_of_n_reads_one_nth(step, share):
    """A pixel whose colour moves past SSR_TOLERANCE in one channel (or
    turns NaN) counts once; a move under it does not."""
    ref = torch.rand(3, 8, 16, generator=torch.Generator().manual_seed(3))
    prog = ref.clone()
    prog[1, 5, 7] += step
    got = check.compare(_targets(prog), _targets(ref))
    assert got["ssr"] == share / (8 * 16)
    assert check.compare(_targets(ref), _targets(ref))["ssr"] == 0.0


def test_the_number_is_read_only_where_the_reference_has_it():
    ref = _targets(torch.zeros(3, 8, 16))
    without = {k: v for k, v in ref.items() if k != "ssr"}
    assert "ssr" not in check.compare(ref, without)
    assert check.compare(without, ref)["ssr"] == float("inf")


def test_the_numbers_keep_their_order():
    assert check.NUMBERS == PARENT_NUMBERS + ("ssr",)


def test_the_reference_march_imports_nothing_of_the_program_or_jax():
    """reference/ssr.py imports torch and the reference's own modules."""
    import ast
    with open(ref_ssr.__file__) as f:
        tree = ast.parse(f.read())
    absolute = sorted(a.name for n in ast.walk(tree)
                      if isinstance(n, ast.Import) for a in n.names) + \
        sorted(n.module for n in ast.walk(tree)
               if isinstance(n, ast.ImportFrom) and n.level == 0)
    relative = {n.module or "" for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom) and n.level > 0}
    assert absolute == ["torch", "__future__"], absolute
    here = os.path.dirname(ref_ssr.__file__)
    assert all(os.path.exists(os.path.join(here, (m or "__init__") + ".py"))
               for m in relative), relative
