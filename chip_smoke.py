"""Smoke run of the PyTorch/CUDA renderer on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the ten hand-written CUDA kernels (and K5's variants) from
``soc_real_time_renderer_tpu_torch/kernels/csrc`` (K1 bin resolve, K2
SSAO taps, K3 TAA history fetch, K3f the whole TAA resolve around it,
K4 shadow depth resolve, K5 material texture tap, K6 noise-texture sky
LUT, K6p procedural sky LUT, K7 point and spot lights, K8 the SSR
march), then
renders four scenes at 1920x1088 with every other RenderConfig default
(4096^2 shadow map):

* ``terrain``: ``scenes.build("terrain")``, BASELINE config 4.  Its
  path runs K1, K2, K3f, K5 and K6p (the sun shadow is proved empty,
  there is no cloud noise, so the sky LUT is the procedural one).
* ``full_nohelmet``: BASELINE config 5 without its helmet: the
  procedural atrium (five flat materials) at scale 0.01 plus the
  terrain at y = -8, animated camera, and a (64, 64) cloud-noise field
  made from a seed (the shape class of assets/Clouds/noise.png).  K1,
  K2, K3f, K5, K6.
* ``atrium_lifted``: BASELINE config 6 with the atrium in the helmet's
  place at y = 32, inside the sun's volume, so the 4096^2 shadow view
  is rastered and sampled through its proved crop; given the same
  noise field.  All six kernels of the noise path (every kernel but
  K6p, K7 and K3 alone, whose fetch K3f does).
* ``full_lit_nohelmet``: ``full_nohelmet`` with the ``full_lit``
  preset's 256 lights (``scenes.full_lit_lights`` through
  ``scenes.add_lights``), so ``_finish`` binds 128 point and 128 spot
  lights and composition shades every pixel by each.  K1, K2, K3f, K5,
  K6 and K7.

Then the passes that are off by default, two frames each, same size:

* ``atrium_passes``: ``atrium_lifted`` whose floor takes the
  ``full_ssr`` preset's tile map (``proc.metal_tile_image``), with SSR
  (composited), depth of field and the volumetric light over the
  rendered shadow map; ``FramePlan.ssr_cap`` the screen's pixel count,
  as the ``full_ssr`` preset sizes it.  The six kernels of the noise
  path and K8, which is held to its plain version on the frame's own
  inputs (dense, capped past and under the reflective pixels, the
  screen's cap: bit for bit) and timed beside its bound
  (``benchmark/roofline.ssr_job`` over the reference march's rays and
  probes).
* ``terrain_perpixel``: the terrain with the noise field and
  ``cloud_impl="perpixel"``: the exact cloud march at every half-res
  pixel, no LUT.  K1, K5, K2, K3f and not K6.

Then ``batched``: B = 4 views of one scene in one step
(``parallel/mesh.make_batched_render_fn``: a leading view axis through
the frame, each kernel launched once for the four views), four distinct
camera positions each, on two scenes at the same size:

* ``atrium_lifted``: all six kernels, K4 rastering each view's sun view;
* ``terrain``: the procedural sky LUT (K6p, one launch for the views),
  the shadow elided, the sun proof checked over the batch (a batch with
  one view under another sun is refused before anything launches);
* ``atrium_passes`` (the atrium_lifted views; ``ssr_cap`` the
  screen's) and ``terrain_perpixel`` (the terrain
  views): SSR, depth of field, the volumetric light and the per-pixel
  cloud march each one call for the four views.  On a batched frame's
  own inputs, each of those passes in one call against four
  single-view calls: bit for bit, ms (median of 5, alternating), and
  the CUDA kernels it issues at B = 4 and at B = 1 counted with
  ``torch.profiler`` (SSR, DoF and compose, at most 1.25x; the cloud
  march's chunk loop runs over (view, row), so its chunks are printed).

For each: two consecutive batched frames with launch counts (each
kernel of the path once per batched frame, the others never); view i of
both frames against ``render_frame`` of view i carrying its own history
(max abs <= 1e-6, the reading printed); each kernel against its plain
version on a batched frame's own inputs (recorded by spying on the
wrappers during a plain-path batched frame), bit for bit; ms per batched
frame against four single-view frames (CUDA events, median of 5,
alternating); ``torch.cuda.max_memory_allocated`` of a batched frame at
B = 1 and B = 4.

Then ``sharded``: one frame of ``atrium_lifted`` (all six kernels) cut
into four row bands over a mesh that names the card four times
(``parallel/mesh.make_mesh(4, dp=1, devices=["cuda:0"] * 4)``, the
split plan's ``raster_stage`` and ``make_sharded_shade_fn``), two
frames carrying history: K1 and K4 once per band of bin rows, K5, K2
and K3f once per band of 272 rows, K6 once (one distinct device), the
counts printed per frame; the assembled colour and history against the
unsplit ``render_frame`` (max abs <= 1e-6, exposure <= 1e-7); every
band-mode launch against its plain version on the band's own inputs
(recorded during a plain-path split frame), bit for bit; ms per frame
split and unsplit; ``max_memory_allocated`` at sp = 1 and sp = 4.  Then
``atrium_passes`` in the same four bands, two frames (SSR, DoF and the
cloud march on the gathered screen, the volumetric term per band):
launches per band as above, colour, hdr, the SSR target, history and
exposure against the unsplit frames (max abs <= 1e-6).  Then
``make_batched_render_fn`` over a (dp = 2, sp = 2) mesh of the card for
the terrain's four views, two frames: each view within 1e-6 of the
unmeshed batched step.

Then the asset path, from a synthetic asset tree written into a
temporary directory at the real assets' sizes
(``soc_real_time_renderer_tpu_torch/tools/synth_assets.py``: a
15,480-triangle helmet whose positions, normals and UVs share one
strided buffer view, five 2048^2 PNG maps of mixed colour types, one
per PNG filter type; Sponza's five materials as fifteen 1024^2 PNGs; a
64^2 grey ``Clouds/noise.png``):

* ``assets``: the seconds for writing the tree, ``load_model`` of the
  helmet, decoding every map by hand (``utils/png.py``) and packing the
  helmet's atlas; whether PIL imports, and where it does, ``decode_png``
  against PIL on every map.
* the four glTF presets ``helmet``, ``helmet_lifted``, ``sponza`` and
  ``full`` through ``scenes.build`` (``scenes.ASSETS`` at the tree), 3
  frames each with launch counts: every preset's batch carries the noise
  field, so K6 runs in all four; K4 in ``helmet_lifted`` alone.  The
  kernel-path frame against the plain-path frame on ``full`` and
  ``helmet_lifted``; CUDA-event frame ms; the stage tables of ``full``
  and ``helmet``.
* ``texparts``: the texture-tap attribution path on ``full``'s build:
  the port's ``tools/capture_texfields.py`` (frame 1's tap fields, what
  ``resolve_gbuffer`` hands K5), ``bench_texsample.py`` (K5 in each
  filter mode, the plain gather, the G-buffer stage),
  ``bench_texkernel_parts.py`` and ``bench_texmm2.py`` (the K5 variants
  that stand for the JAX tools' two TPU kernels, 16 and 7 runs) in this
  process, each with the launch counts set to 0 before and read after;
  then every full variant against its plain version on the capture in
  all three filter modes, bit for bit (bf16 against PyTorch's cast),
  and each variant's card ms beside the full kernel's and its own bound,
  registers and SASS LDG / STG counts (none may be 0: a variant the
  compiler emptied would time nothing).  Its two JSON rows
  (``texsample_parts``, ``texsample_mm2``) carry the full variant's
  numbers and a map from each run to its ms.
* ``cli``: ``python -m soc_real_time_renderer_tpu_torch.tools.render
  --scene full ... --frames 3 --dump-passes`` in a subprocess with
  ``SOC_ASSETS`` at the tree: exit code 0, its PNG against the
  in-process frame (mean abs < 0.5 levels), every pass dumped; then
  ``--pair-cap 4096`` prints the ``PAIRS`` warning and exits 0.
* ``viewer``: the interactive viewer (``ui/server.start_server`` with
  ``frame.make_render_fn``) serving ``full`` from the tree, driven by
  HTTP requests: fly-camera input, a settings override, a second helmet
  (the full rebuild tier), the first helmet into the sun volume (the
  cheap tier; K4 launches from then on), a moved sun, a resize and back,
  a refused resize; each frame's launches, the rebuild tiers' seconds,
  the medians of ``frame_ms`` and ``latency_ms`` from ``/metrics``, each
  kernel against its plain version on the final state's inputs, and a
  ``utils/metrics.GPUMetricPool`` table (``viewer_phase``).
* ``bench``: the port's three measuring tools' mains in this process on
  the same tree: ``tools/bench.py`` on ``sponza`` at 1280x736, 32
  frames (its JSON line: ``assets`` synthetic, K1, K5, K2, K6 and K3f 32
  times each); ``tools/bench_baselines.py`` over the seven BASELINE
  configurations at 8 frames (each row's kernels once a frame, all six
  kernels over the table); ``tools/bench_toggle.py --config 5`` with
  every toggle it keeps, 8 frames a run (a median delta and its spread
  for each, its kernel gone from the toggles that remove one).

The stage tables time ``raster_stage`` with the plan's grids and with
``BinGrid.large_cap`` 0 (binning without its third tier, the JAX
package's cut at ``med_slots`` bins) in turns, medians of six each, and
the spread of the plan's readings: the third tier's cost against it.

The atrium scenes are composed from ``Scene`` + ``scenes._finish``, as
the JAX package composes its presets.  For each of the first four
scenes: the build, the
spread of each rastered view's pairs over its bins (mean and heaviest
bin, the pairs wholly behind the camera), each kernel of its path
against its plain PyTorch version on the frame's own inputs (K1, K3f,
K4, K5, K6 and K7 bit for bit, and K3 alone on the fused resolve's fetch
inputs), 8 frames through ``render_frame`` (launch counts
set to 0 just before, read just after: each kernel of the path launches
once per frame, the others never), the kernel-path frame against the
plain-path frame, frame times with CUDA events, kernel times per call
(``ms``, the wrapper's host time included) and on the card alone
(``device_ms``: L2 evicted before each call, calls queued behind a
sleeping kernel so that the host's launch path is hidden; a call that
waits for the card fails the run; for K6 also ``launch_device_ms``, its
launch alone without the wrapper's small PyTorch kernels around it), and
a per-stage breakdown.  For the two scenes of the passes: launch counts
over their frames, the kernel-path frame against the plain-path frame,
each pass's own checks (``passes_phase``, ``perpixel_phase``; in
``atrium_passes`` the 5% cap that ``_finish`` sizes by default sets bit
16)
and the stage breakdown with their rows.
Any failure exits nonzero before the last line; on success the line
before the last is the per-kernel JSON and the last line the contract
line ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

from soc_real_time_renderer_tpu_torch.utils.metrics import cuda_ms, \
    device_ms, l2_flush

WIDTH, HEIGHT = 1920, 1088
FRAMES = 8
TIMED = 5
PASS_FRAMES = 2        # frames of the atrium_passes / terrain_perpixel paths
PRESET_FRAMES = 3      # frames of each glTF preset (the CLI renders as many)
PRESETS = ("helmet", "helmet_lifted", "sponza", "full")   # "full" last:
#                        its last frame is the CLI phase's reference
VIEWER_INPUTS = 30     # fly-camera inputs of the viewer phase
# the batched phase's views: distinct camera positions per scene
BATCH_POSITIONS = {
    "atrium_lifted": ([-7.0, 33.8, 0.0], [-4.0, 35.0, 2.0],
                      [-8.0, 34.5, -2.5], [-2.0, 34.0, -1.0]),
    # near the preset camera; from [20, 18, 20] triangles near the camera
    # span 72-176 bins, past med_slots: build_pairs' third tier
    # (BinGrid.large_cap) keeps their coverage, overflow stays 0
    "terrain": ([20.0, 12.0, 20.0], [21.0, 14.0, 19.0], [19.0, 16.0, 21.0],
                [20.0, 18.0, 20.0]),
}
# the passes that are off by default, batched: the same views
BATCH_POSITIONS["atrium_passes"] = BATCH_POSITIONS["atrium_lifted"]
BATCH_POSITIONS["terrain_perpixel"] = BATCH_POSITIONS["terrain"]
# the SSR pass's CUDA kernels at B = 4 over those at B = 1: one batched
# call, not one per view, at most this ratio
SSR_LAUNCH_RATIO = 1.25
BATCH_FRAMES = 2
SHARD_BANDS = 4        # row bands of the sharded phase (one card)
SHARD_FRAMES = 2
VIEWER_SAMPLES = 20    # /metrics readings (distinct frames) it takes
BENCH_FRAMES = 32      # tools/bench.py's default frame count
TABLE_FRAMES = 8       # frames a run of bench_baselines and bench_toggle
TOGGLE_CONFIG = 5      # the BASELINE config bench_toggle attributes
ASSET_SEED = 0
NOISE_SEED = 11
METAL_SEED = 5
# LUT against per-pixel clouds, mean abs over the peak sky luminance: the
# pin of tests/test_ops.py::test_sky_lut_error_sweep_sun_angles, which
# PARITY.md (T12) cites; PARITY.md's own readings there, with procedural
# noise, are mean 0.0031 and worst pixel 0.041
LUT_MEAN_BOUND = 0.10

# the card's peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM bytes/s
# and f32 operations/s outside the tensor cores
HBM_BPS = 3.35e12
F32_OPS = 67e12

# f32 operations per unit of work, counted from each kernel's source
# (a transcendental function or a division counts as one)
RESOLVE_OPS = 30       # (pair, pixel) the plain version finds covered: 3
#                        edge functions, 3 sign tests, ez, ew, ew > 0,
#                        z = ez / ew, 0 <= z <= 1, min
SSAO_OPS = 80          # tap: sample point, projection, occluder, range check
TAA_OPS_PIXEL = 10     # uv - velocity, floor, weights
TAA_OPS_CHANNEL = 9    # bilinear blend of one channel
TAA_OPS_RESOLVE = 150  # the 3x3 pass (9 taps: 3 channels of min, max,
#                        weighted add; the depth test), the clamp, the
#                        blend and the disocclusion (length, lerp)
TEX_OPS_CHANNEL = 10   # unpack 4 corners, bilinear blend, / 255
SKY_OPS_ATMOS = 3400   # atmosphere of one texel: 16 x (8 + 1) samples
SKY_OPS_DENSITY = 250  # one cloud density: 4 octaves x 2 slices x 4 taps
SKY_OPS_DENSITY_HASHED = 490   # one density over the value noise: 4
#                        octaves x 2 slices x (4 hashes of 7: 2 mul, add,
#                        sin, mul, fmod, wrap; 23 lattice and blend ops)
SKY_OPS_SAMPLE = 40    # one march sample's phase, powder, scatter terms
LIGHT_OPS_POINT = 56   # (point light, pixel): to the light, d2 and its
#                        clamp, sqrtf, direction, half vector and its
#                        norm, diffuse, acosf(clamped dot), expf, falloff,
#                        three channels' colour, albedo and sum
LIGHT_OPS_SPOT = 66    # (spot light, pixel): a point's 56 and the cone's
#                        dot, subtraction, division and clamp
LIGHT_BYTES_PIXEL = 48  # albedo, normal, position read; the sum written

SRC = "soc_real_time_renderer_tpu_torch/kernels/csrc/"
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "resolve": (SRC + "resolve.cu",
                "soc_real_time_renderer_tpu/ops/raster2.py:556"),
    "resolve_depth": (SRC + "resolve.cu",
                      "soc_real_time_renderer_tpu/ops/raster2.py:447"),
    "texsample": (SRC + "texsample.cu",
                  "soc_real_time_renderer_tpu/ops/texsample.py:488"),
    "ssao_taps": (SRC + "ssao.cu",
                  "soc_real_time_renderer_tpu/ops/ssao.py:244"),
    "sky_lut": (SRC + "sky.cu",
                "soc_real_time_renderer_tpu/ops/sky_pallas.py:149"),
    # replaces no TPU kernel: the JAX package marches the procedural LUT
    # in XLA (ops/clouds.py render_sky_lut); added for the card's
    # measurement of the plain march (PERF.md section 5: half of the
    # terrain frame, thousands of launches)
    "sky_lut_procedural": (SRC + "sky.cu",
                           "none (soc_real_time_renderer_tpu/ops/clouds.py "
                           "render_sky_lut, XLA)"),
    "taa_reproject": (SRC + "taa.cu",
                      "soc_real_time_renderer_tpu/ops/taa_pallas.py:30"),
    # K3 fused with the resolve around it, which the JAX package leaves
    # to XLA (ops/taa.py taa): the frame's TAA pass in one launch (its
    # plain version is ~417, PERF.md section 6); K3 alone is compared
    # on the frame's fetch inputs beside it
    "taa_resolve": (SRC + "taa.cu",
                    "none (soc_real_time_renderer_tpu/ops/taa.py taa, XLA "
                    "around taa_pallas.py:30)"),
    # replaces no TPU kernel: the JAX package shades the point and spot
    # lights as a lax.scan in XLA; added for the lit atrium, whose 256
    # lights the plain loop shades in ~14,000 launches a frame
    "local_lights": (SRC + "lights.cu",
                     "none (soc_real_time_renderer_tpu/ops/composition.py "
                     "_local_lights, a lax.scan in XLA)"),
    # replaces no TPU kernel: the JAX package marches its reflections in
    # XLA; added for the reflective atrium, whose march the plain version
    # runs in ~9,600 launches a frame
    "ssr_march": (SRC + "ssr.cu",
                  "none (soc_real_time_renderer_tpu/ops/ssr.py ssr, XLA)"),
}
# the scene whose inputs give each kernel's line in the JSON
# the two TPU kernels that took K5 apart, as K5 variants on the card:
# name -> (source, the TPU kernel, the port tool that times them)
VARIANT_KERNELS = {
    "texsample_parts": (SRC + "texsample.cu",
                        "tools/bench_texkernel_parts.py:32",
                        "bench_texkernel_parts"),
    "texsample_mm2": (SRC + "texsample.cu", "tools/bench_texmm2.py:38",
                      "bench_texmm2"),
}
# the scene whose inputs give each kernel's line in the JSON
HOME = {"resolve": "terrain", "ssao_taps": "terrain",
        "taa_reproject": "terrain", "taa_resolve": "terrain",
        "texsample": "full_nohelmet",
        "sky_lut": "full_nohelmet", "resolve_depth": "atrium_lifted",
        "sky_lut_procedural": "terrain",
        "local_lights": "full_lit_nohelmet", "ssr_march": "atrium_passes"}
# the kernels no frame launches on its own: K3, whose fetch the frame's
# fused TAA resolve (taa_resolve) does
STANDALONE = ["taa_reproject"]
# the kernels that launch only where the plan binds a light: K7
LIT = ["local_lights"]
# the kernels that launch only where enable_ssr: K8
SSR = ["ssr_march"]
# the kernels of a lightless scene with the cloud-noise texture and SSR
# off: all but K6p, K7 and K8
NOISE_PATH = sorted(k for k in KERNELS if k != "sky_lut_procedural"
                    and k not in STANDALONE + LIT + SSR)


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_kernels(fn):
    """The CUDA kernels the card ran during fn(), counted with
    torch.profiler (CUPTI, ProfilerActivity.CUDA): its kernel events,
    copies and fills left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset")))


def smi(query):
    """The first card's `nvidia-smi --query-gpu=<query>` line."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip() \
        .splitlines()[0]


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    f32 operations over the f32 peak."""
    tb, to = nbytes / HBM_BPS * 1e3, ops / F32_OPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def cloud_noise():
    """The (64, 64) smooth tiled noise field of tests/test_sky_pallas.py,
    made from NOISE_SEED."""
    import numpy as np
    rng = np.random.default_rng(NOISE_SEED)
    base = rng.random((16, 16)).astype(np.float32)
    sm = np.kron(base, np.ones((4, 4), np.float32))
    k = np.ones((3, 3), np.float32) / 9.0
    for _ in range(2):
        padded = np.pad(sm, 1, mode="wrap")
        sm = sum(padded[dy:dy + 64, dx:dx + 64] * k[dy, dx]
                 for dy in range(3) for dx in range(3))
    return sm.astype(np.float32)


def build_scene(name, dev):
    """The BuiltScene of `name` at WIDTH x HEIGHT on `dev`."""
    import dataclasses
    import torch
    from soc_real_time_renderer_tpu_torch import scenes
    from soc_real_time_renderer_tpu_torch.config import RenderConfig
    from soc_real_time_renderer_tpu_torch.models import proc
    from soc_real_time_renderer_tpu_torch.scene.components import \
        MeshComponent, TransformComponent
    from soc_real_time_renderer_tpu_torch.scene.scene import Scene
    from soc_real_time_renderer_tpu_torch.models.gltf import MaterialData
    cfg = RenderConfig(width=WIDTH, height=HEIGHT)
    if name == "terrain":
        return scenes.build("terrain", cfg, device=dev)
    if name == "terrain_perpixel":
        built = scenes.build("terrain", cfg.replace(cloud_impl="perpixel"),
                             device=dev)
        built.batch = dataclasses.replace(
            built.batch, cloud_noise=torch.from_numpy(cloud_noise()).to(dev))
        return built
    scene = Scene(name)
    models = []

    def entity(ename, model, position=None, scale=None):
        e = scene.create_entity(ename)
        tc = e.add_component(TransformComponent())
        if scale is not None:
            tc.set_scale(scale)
        if position is not None:
            tc.set_position(position)
        e.add_component(MeshComponent()).model = model
        models.append(model)

    atrium = proc.build_atrium(texture_dir=None)
    if name in ("full_nohelmet", "full_lit_nohelmet"):
        entity("sponza model", atrium, scale=[0.01] * 3)
        entity("terrain", scenes._terrain_model(), position=[0.0, -8.0, 0.0])
        if name == "full_lit_nohelmet":
            scenes.add_lights(scene, scenes.full_lit_lights())
        built = scenes._finish(scene, models, cfg, [-7.0, 1.8, 0.0],
                               [0, 1.5, 0], animate=True, device=dev)
    else:
        kw = {}
        if name == "atrium_passes":    # the floor (material 0) reflects
            atrium.images = [proc.metal_tile_image(METAL_SEED)]
            atrium.materials[0] = MaterialData(metallic_roughness_image=0)
            cfg = cfg.replace(enable_ssr=True, composite_ssr=True,
                              enable_depth_of_field=True,
                              enable_volumetric_light=True)
            # the full_ssr preset's cap: no reflective pixel is dropped
            kw["ssr_cap"] = WIDTH * HEIGHT
        entity("sponza model", atrium, position=[0.0, 32.0, 0.0],
               scale=[0.01] * 3)
        built = scenes._finish(scene, models, cfg, [-7.0, 33.8, 0.0],
                               [0, 33.5, 0], device=dev, **kw)
    built.batch = dataclasses.replace(
        built.batch, cloud_noise=torch.from_numpy(cloud_noise()).to(dev))
    return built


def path_of(plan, batch):
    """The kernels `render_frame` launches for this plan and batch."""
    from soc_real_time_renderer_tpu_torch.tools.bench import kernel_path
    return kernel_path(plan, batch)


def skew(name, view, starts, recs, grid):
    """Logs how the view's pairs spread over its bins: pairs, mean and
    maximum pairs per bin (and which bin), the pairs whose records have
    no w > 0 (max(w) <= 0: wholly behind the camera), and the heaviest
    bin without them."""
    import torch
    n = int(starts[-1])
    per_bin = (starts[1:] - starts[:-1]).long()
    dead = ~(recs[12:15, :n] > 0).any(dim=0)
    pair_bin = torch.searchsorted(
        starts, torch.arange(n, dtype=starts.dtype, device=starts.device),
        right=True) - 1
    live = torch.zeros_like(per_bin).index_add_(
        0, pair_bin[~dead], torch.ones_like(pair_bin[~dead]))
    top, top_live = int(per_bin.argmax()), int(live.argmax())
    log(f"[{name}] {view} view pairs: {n} over {grid.num_bins} bins, mean "
        f"{n / grid.num_bins:.1f} per bin, max {int(per_bin[top])} in bin "
        f"{top} ({int(per_bin[top] - live[top])} of them with max(w) <= 0);"
        f" pairs with max(w) <= 0: {int(dead.sum())}; without them the "
        f"heaviest bin is {top_live} with {int(live[top_live])}")


def kernel_cases(name, built, dev, min_lit=0.1):
    """Per kernel of the scene's path: (call(impl), compare(k, p) ->
    (max_abs_err, message, ok), (bytes, operations), library call or
    None, the kernel's launch alone or None where the wrapper runs no
    other device work), all on the frame's own inputs: a plain-path warm
    frame (frame 0) gives the G-buffer, history and texture-tap inputs,
    frame 1's globals the rest.  K4's map (or crop) must have at least
    `min_lit` of its texels below the 1.0 clear, and some."""
    import torch
    from soc_real_time_renderer_tpu_torch.graph import frame as fm
    from soc_real_time_renderer_tpu_torch.ops import composition, raster2, \
        sky, ssao, ssr, taa, texsample
    plan, batch = built.plan, built.batch
    cfg = plan.config
    path = path_of(plan, batch)

    taps = {}
    real_sample_atlas = texsample.sample_atlas
    real_local_lights = composition._local_lights
    real_ssr = ssr.ssr

    def spy(*a, **k):        # records the frame's (mid, uv, lod)
        taps.setdefault("args", (a, {n: v for n, v in k.items()
                                     if n != "impl"}))
        return real_sample_atlas(*a, **k)

    def spy_lights(*a, **k):  # records composition's G-buffer planes
        taps.setdefault("lights", (a, {n: v for n, v in k.items()
                                       if n != "impl"}))
        return real_local_lights(*a, **k)

    def spy_ssr(*a, **k):     # records the SSR pass's targets and globals
        taps.setdefault("ssr", a)
        return real_ssr(*a, **k)

    texsample.sample_atlas = spy
    composition._local_lights = spy_lights
    ssr.ssr = spy_ssr
    try:
        hist = fm.RenderHistory.create(cfg, device=dev)
        g, mm, nm = built.frame_globals(0)
        out0, hist1 = fm.render_frame(plan, batch, g, hist, mm, nm,
                                      impl="plain")
    finally:
        texsample.sample_atlas = real_sample_atlas
        composition._local_lights = real_local_lights
        ssr.ssr = real_ssr
    g1, mm1, nm1 = built.frame_globals(1, peek=True)
    torch.cuda.synchronize()
    world, _ = fm.transform_triangles(batch, mm1, nm1)
    cases = {}

    # K1: the main view
    clip = fm._clip_of(world, g1.camera.projection_view)
    setup = raster2.triangle_setup_planar(clip, WIDTH, HEIGHT, "front")
    starts, recs, ovf, rgrid = raster2.gather_records(setup, plan.main_grid)
    n1 = int(starts[-1])
    check(n1 > 0 and int(ovf) == 0, f"main view: {n1} pairs, overflow "
          f"{int(ovf)}")
    skew(name, "main", starts, recs, rgrid)

    def cmp_resolve(k, p):
        agree = k[1] == p[1]
        a = agree.float().mean().item()
        e = (k[0] - p[0]).abs().max().item()
        return e, (f"{n1} pairs, tri_id agreement {a:.6f} (== 1), depth "
                   f"max abs {e:.3g} (== 0)"), a == 1.0 and e == 0.0

    hp, wp = rgrid.by * rgrid.bh, rgrid.bx * rgrid.bw
    cases["resolve"] = (
        lambda i: raster2.resolve(starts, recs, rgrid, impl=i), cmp_resolve,
        (starts.numel() * 4 + 16 * n1 * 4 + hp * wp * 8,
         resolve_ops(starts, recs, rgrid)), None, None)

    # K4: the sun shadow view
    if "resolve_depth" in path:
        S = cfg.shadow_resolution
        sclip = fm._clip_of(world, g1.sun.projection_view)
        ssetup = raster2.triangle_setup_planar(sclip, S, S, "back")
        sst, srec, sovf, sgrid = raster2.gather_records(ssetup,
                                                        plan.shadow_grid)
        n4 = int(sst[-1])
        check(n4 > 0 and int(sovf) == 0,
              f"shadow view: {n4} pairs > 0, overflow {int(sovf)} == 0")
        skew(name, "shadow", sst, srec, sgrid)

        def cmp_depth(k, p):
            e = (k - p).abs().max().item()
            crop = plan.shadow_crop
            win = (k[crop[1]:crop[1] + crop[3], crop[0]:crop[0] + crop[2]]
                   if crop is not None else k[:S, :S])
            lit = (win < 1.0).float().mean().item()
            return e, (f"{n4} pairs, overflow 0, depth max abs {e:.3g} "
                       f"(== 0), texels < 1.0: {lit:.4f} of the "
                       f"{'crop' if crop else 'map'} (>= {min_lit}, > 0)"), \
                e == 0.0 and lit >= min_lit and lit > 0.0

        sp = sgrid.by * sgrid.bh * sgrid.bx * sgrid.bw
        cases["resolve_depth"] = (
            lambda i: raster2.resolve_depth(sst, srec, sgrid, impl=i),
            cmp_depth, (sst.numel() * 4 + 15 * n4 * 4 + sp * 4,
                        resolve_ops(sst, srec, sgrid)), None, None)

    # K5: the material tap at the frame's (mid, uv, lod)
    if "texsample" in path:
        check("args" in taps, "the warm frame took the material tap")
        (atlas, mid, uv, lod), kw = taps["args"]
        P = mid.numel()
        rows = tap_rows(mid, uv, lod, kw)
        levels = 2 if kw["filter_mode"] == "trilinear" else 1

        def cmp_tex(k, p):
            e = (k - p).abs().max().item()
            return e, (f"{P} pixels, {kw['filter_mode']}, max abs {e:.3g} "
                       f"(== 0)"), e == 0.0

        cases["texsample"] = (
            lambda i: texsample.sample_atlas(atlas, mid, uv, lod, impl=i,
                                             **kw),
            cmp_tex, (P * (4 + 8 + 4 + 44) + rows * 48,
                      P * 11 * TEX_OPS_CHANNEL * levels), None, None)

    # K2: SSAO taps
    depth = out0.gbuffer.depth
    pre = ssao._preamble(depth, out0.gbuffer.normal, g1)
    planes = torch.cat(pre, dim=0)
    kern = ssao.kernel_vectors(cfg.ssao_kernel_size, dev)
    k2_args = (planes, depth, g1.camera.projection,
               g1.camera.inv_projection, g1.ssao_radius, g1.ssao_bias, kern)

    def cmp_ssao(k, p):
        e = (k - p).abs().max().item()
        return e, f"{tuple(k.shape)}: max abs {e:.3g} (== 0)", e == 0.0

    h2, w2 = planes.shape[1:]
    cases["ssao_taps"] = (
        lambda i: ssao.ssao_taps(*k2_args, impl=i), cmp_ssao,
        ((planes.numel() + depth.numel() + h2 * w2) * 4,
         h2 * w2 * kern.shape[0] * SSAO_OPS), None, None)

    # K6: the sky LUT over the noise texture
    if "sky_lut" in path:
        noise = batch.cloud_noise
        n_tex, n_up, n_hit = sky_counts(g1, noise)

        def cmp_sky(k, p):
            d = (k - p).abs()
            scale = max(p.abs().max().item(), 1e-6)
            mx, mn = d.max().item() / scale, d.mean().item() / scale
            return d.max().item(), (
                f"{tuple(k.shape)}: max abs {d.max().item():.3g} (== 0), "
                f"max abs / scale {mx:.3g}, mean abs / scale {mn:.3g}, "
                f"scale {scale:.4g}, {n_hit} of {n_up * 24} march samples "
                f"hold cloud"), d.max().item() == 0.0

        sky_block = sky.sky_params(g1)
        cases["sky_lut"] = (
            lambda i: sky.render_sky_lut_noise(g1, noise, impl=i), cmp_sky,
            ((16 + noise.numel() + 3 * n_tex) * 4,
             n_tex * SKY_OPS_ATMOS
             + n_up * 24 * (SKY_OPS_DENSITY + SKY_OPS_SAMPLE)
             + n_hit * 10 * SKY_OPS_DENSITY), None,
            lambda: sky.launch_sky_lut(sky_block, noise))

    # K6p: the sky LUT over the procedural value noise
    if "sky_lut_procedural" in path:
        n_tex, n_up, n_hit = sky_counts(g1, None)

        def cmp_sky_p(k, p):
            nan = torch.isnan(p)
            same_nan = bool(torch.equal(torch.isnan(k), nan))
            d = (k - p)[~nan].abs()
            e = d.max().item() if d.numel() else 0.0
            return e, (f"{tuple(k.shape)}: max abs {e:.3g} (== 0), NaN "
                       f"texels {int(nan.sum())} at the same places "
                       f"{same_nan}, {n_hit} of {n_up * 24} march samples "
                       f"hold cloud"), e == 0.0 and same_nan

        block_p = sky.sky_params(g1)
        cases["sky_lut_procedural"] = (
            lambda i: sky.render_sky_lut_procedural(g1, impl=i), cmp_sky_p,
            ((16 + 3 * n_tex) * 4,
             n_tex * SKY_OPS_ATMOS
             + n_up * 24 * (SKY_OPS_DENSITY_HASHED + SKY_OPS_SAMPLE)
             + n_hit * 10 * SKY_OPS_DENSITY_HASHED), None,
            lambda: sky.launch_sky_lut(block_p))

    # K7: the point and spot lights on the warm frame's own globals and
    # composition planes (albedo, normal, world position)
    if "local_lights" in path:
        check("lights" in taps, "the warm frame shaded its lights")
        (gl, alb, nrm, pos, n_pt, n_sp), _ = taps["lights"]
        P7 = pos[0].numel()

        def cmp_lights(k, p):
            e = (k - p).abs().max().item()
            return e, (f"{n_pt} point and {n_sp} spot slots over {P7} "
                       f"pixels, max abs {e:.3g} (== 0, torch.equal "
                       f"{torch.equal(k, p)})"), torch.equal(k, p)

        cases["local_lights"] = (
            lambda i: composition._local_lights(gl, alb, nrm, pos, n_pt,
                                                n_sp, impl=i),
            cmp_lights, (P7 * LIGHT_BYTES_PIXEL,
                         P7 * (n_pt * LIGHT_OPS_POINT
                               + n_sp * LIGHT_OPS_SPOT)), None, None)

    # K8: the SSR march on the warm frame's own targets and globals
    if "ssr_march" in path:
        check("ssr" in taps, "the warm frame marched its reflections")
        *targets, g0 = taps["ssr"]
        cases["ssr_march"] = ssr_case(targets, g0, plan.ssr_cap)

    # K3: TAA history fetch, alone
    *_, vel_s = taa.neighbourhood(out0.hdr, depth, out0.gbuffer.velocity)
    packed = torch.cat([hist1.previous_color, hist1.previous_velocity], 0)
    C, H, W = packed.shape

    def cmp_taa(k, p):
        e = (k - p).abs().max().item()
        return e, f"{tuple(k.shape)}: max abs {e:.3g} (== 0)", e == 0.0

    cases["taa_reproject"] = (
        lambda i: taa.reproject_history(packed, vel_s, impl=i), cmp_taa,
        (C * H * W * 2 + 2 * H * W * 4 + C * H * W * 4,
         H * W * (TAA_OPS_PIXEL + C * TAA_OPS_CHANNEL)),
        grid_sample_call(packed, vel_s), None)

    # K3f: the whole TAA resolve, on the frame's hdr, depth, velocity and
    # history; bytes: colour, depth, velocity and the bf16 history read,
    # colour written (the neighbourhood's reads of a texel counted once)
    taa_in = (out0.hdr, depth, out0.gbuffer.velocity, hist1.previous_color,
              hist1.previous_velocity, g1.frame_counter)
    cases["taa_resolve"] = (
        lambda i: taa.taa(*taa_in, impl=i), cmp_taa,
        (H * W * (12 + 4 + 8 + C * 2 + 12),
         H * W * (TAA_OPS_RESOLVE + TAA_OPS_PIXEL + C * TAA_OPS_CHANNEL)),
        None, None)
    return path, cases


def ssr_case(targets, g, cap):
    """K8's case in kernel_cases' form on a frame's SSR inputs, `targets`
    (depth, albedo, normal, metallic-roughness) and globals `g`, at
    `cap`: bit for bit its plain version in the image, the overflow and
    the count; bytes and operations of benchmark/roofline.py's ssr_job
    over the rays and probes of the benchmark reference's dense march."""
    import torch
    from benchmark import roofline
    from benchmark.reference import ssr as ref_ssr
    from soc_real_time_renderer_tpu_torch.ops import ssr
    _, work = ref_ssr.ssr(*targets, g)

    def cmp(k, p):
        e = (k[0] - p[0]).abs().max().item()
        same = all(torch.equal(a, b) for a, b in zip(k, p))
        return e, (f"cap {cap}: {work['rays']} rays, {work['probes']} "
                   f"probes, image max abs {e:.3g} (== 0), overflow "
                   f"{k[1].tolist()} / {p[1].tolist()}, count "
                   f"{k[2].tolist()} / {p[2].tolist()}, equal {same}"), same

    return (lambda i: ssr.ssr(*targets, g, compact_cap=cap, impl=i), cmp,
            roofline.ssr_job(**work), None, None)


def resolve_ops(starts, recs, grid, pixels_per_chunk=1 << 24):
    """f32 operations any exact bin resolve must do on these records:
    the edge test and the depth at each (pair, pixel) that the plain
    version finds covered (its _eval_records; pairs chunked as
    resolve_depth_plain chunks them).  Tests that find no coverage are
    work a resolve may skip, as K1's rejects do."""
    import torch
    from soc_real_time_renderer_tpu_torch.ops import raster2
    dev = recs.device
    bw, bh, bx = grid.bw, grid.bh, grid.bx
    n = int(starts[-1])
    pix = torch.arange(bw * bh, device=dev)
    lx, ly = pix % bw, torch.div(pix, bw, rounding_mode="floor")
    step = max(1, pixels_per_chunk // (bw * bh))
    covered = torch.zeros((), dtype=torch.int64, device=dev)
    for p0 in range(0, n, step):
        p = torch.arange(p0, min(p0 + step, n), device=dev)
        b = torch.searchsorted(starts, p.to(starts.dtype), right=True) - 1
        px = ((b % bx * bw)[:, None] + lx[None, :]).to(torch.float32) + 0.5
        py = ((torch.div(b, bx, rounding_mode="floor") * bh)[:, None]
              + ly[None, :]).to(torch.float32) + 0.5
        cov, _ = raster2._eval_records(recs[:, p][:, :, None], px, py)
        covered += cov.sum()
    return int(covered) * RESOLVE_OPS


def tap_rows(mid, uv, lod, kw):
    """The number of distinct atlas rows the material tap reads: the
    row arithmetic of gbuffer.sample_packed_atlas at each level it
    takes."""
    import torch
    size, stride, n_levels = kw["size"], kw["layer_stride"], kw["n_levels"]
    mode = kw["filter_mode"]
    lodc = torch.clamp(lod, 0.0, float(n_levels - 1))
    if mode == "trilinear":
        l0 = torch.floor(lodc).long()
        levels = [l0, torch.clamp(l0 + 1, max=n_levels - 1)]
    else:
        levels = [torch.round(lodc).long()]
    uvw = uv - torch.floor(uv)
    rows = []
    for lv in levels:
        s = torch.bitwise_right_shift(torch.full_like(lv, size), lv)
        off = torch.div(4 * size * size - 4 * s * s, 3, rounding_mode="floor")
        x = uvw[0] * s.float() - 0.5
        y = uvw[1] * s.float() - 0.5
        if mode == "nearest":
            xi, yi = torch.round(x).long(), torch.round(y).long()
        else:
            xi, yi = torch.floor(x).long(), torch.floor(y).long()
        rows.append(mid.long() * stride + off + torch.remainder(yi, s) * s
                    + torch.remainder(xi, s))
    return int(torch.unique(torch.cat(rows)).numel())


def sky_counts(g, noise, lut_w=256, lut_h=128, steps=24):
    """(LUT texels, texels above the horizon, march samples above the
    horizon that hold cloud): the work of the sky LUT over the noise
    texture (K6; noise None: over the value noise, K6p) for these
    globals, by the plain version's own march positions."""
    import math
    import torch
    from soc_real_time_renderer_tpu_torch.ops import clouds
    dev = g.sun.direction.device
    az = ((torch.arange(lut_w, dtype=torch.float32, device=dev) + 0.5)
          / lut_w * 2.0 * math.pi - math.pi)
    el = ((torch.arange(lut_h, dtype=torch.float32, device=dev) + 0.5)
          / lut_h * math.pi - math.pi / 2)
    ce, se = torch.cos(el)[:, None], torch.sin(el)[:, None]
    shape = (lut_h, lut_w)
    ray = torch.stack([(ce * torch.cos(az)[None]).expand(shape),
                       se.expand(shape),
                       (ce * torch.sin(az)[None]).expand(shape)], -1)
    up = clouds._vec([0.0, clouds.EARTH_RADIUS, 0.0], dev)
    _, bottom = clouds._rsi(up, ray, clouds.EARTH_RADIUS + clouds.CLOUD_MIN)
    _, top = clouds._rsi(up, ray, clouds.EARTH_RADIUS + clouds.CLOUD_MAX)
    start = ray * bottom[..., None]
    inc = (ray * top[..., None] - start) / steps
    ii = torch.arange(steps, dtype=torch.float32, device=dev)
    cpos = start + inc * 0.5 + inc * ii.reshape(-1, 1, 1, 1)
    od = clouds._get_clouds(cpos, g.camera.position, g.elapsed_time, noise)
    upper = ray[..., 1] >= 0.0
    return (lut_w * lut_h, int(upper.sum()),
            int(((od > 0.0) & upper[None]).sum()))


def grid_sample_call(history, velocity):
    """One PyTorch call that computes K3's function (bilinear,
    clamp-to-edge fetch of the history at uv - velocity): grid_sample
    with border padding, its inputs converted beforehand."""
    import torch
    from soc_real_time_renderer_tpu_torch.ops import sampling
    C, H, W = history.shape
    uv = sampling.grid_uv(H, W, history.device)
    grid = torch.stack([uv[0] - velocity[0], uv[1] - velocity[1]], -1)
    grid = (grid * 2.0 - 1.0)[None].contiguous()
    hist = history.to(torch.float32)[None].contiguous()
    return lambda: torch.nn.functional.grid_sample(
        hist, grid, mode="bilinear", padding_mode="border",
        align_corners=False)


def stage_table(built, g, hist, mm, nm, reps=3, plan=None):
    """ms of each stage of one kernel-path frame on these inputs (CUDA
    events, median of `reps`), in shade_stage's order."""
    import torch
    from soc_real_time_renderer_tpu_torch.graph import frame as fm
    from soc_real_time_renderer_tpu_torch.ops import bloom, clouds, \
        composition, dof, exposure, gbuffer, hiz, raster2, sampling, sky, \
        ssao, ssr, taa, tonemap
    plan, batch = plan or built.plan, built.batch
    cfg = plan.config
    st = {}
    st["whole frame"] = cuda_ms(
        lambda: fm.render_frame(plan, batch, g, hist, mm, nm), reps)
    # the third binning tier (BinGrid.large_cap) against the stage's
    # spread: the plan's grids and large_cap 0 (no third tier) in turns
    uncut = dataclasses.replace(plan, **{
        k: dataclasses.replace(getattr(plan, k), large_cap=0)
        for k in ("main_grid", "shadow_grid")})
    turns = ([], [])
    for i in range(2 * reps):
        for j in ((0, 1) if i % 2 == 0 else (1, 0)):
            p = (plan, uncut)[j]
            turns[j].append(cuda_ms(
                lambda p=p: fm.raster_stage(p, batch, g, mm, nm), 1))
    st["raster_stage"] = statistics.median(turns[0])
    st["  raster_stage, large_cap 0 (no third tier)"] = statistics.median(
        turns[1])
    st["  raster_stage's spread (max - min of its readings)"] = \
        max(turns[0]) - min(turns[0])
    vis, recs, smap, ovf = fm.raster_stage(plan, batch, g, mm, nm)
    if smap is not None:
        world, _ = fm.transform_triangles(batch, mm, nm)
        sclip = fm._clip_of(world, g.sun.projection_view)
        st["  of which the shadow view (setup, binning, K4)"] = cuda_ms(
            lambda: raster2.rasterize(sclip, plan.shadow_grid, cull="back",
                                      depth_only=True), reps)
    def gb():
        return gbuffer.resolve_gbuffer(
            vis, recs, batch.atlas_packed, g.camera_prev.projection_view,
            atlas_size=plan.atlas_size, layer_stride=plan.atlas_layer_stride,
            n_levels=plan.atlas_n_levels, filter_mode=plan.texture_filter)

    st["resolve_gbuffer (K5)"] = cuda_ms(gb, reps)
    gbuf = gb()
    st["HiZ (min + max)"] = cuda_ms(lambda: [
        hiz.build_hiz(vis.depth, op) for op in ("min", "max")], reps)
    st["bloom"] = cuda_ms(lambda: bloom.bloom(gbuf.emissive,
                                              cfg.bloom_mip_count), reps)
    emissive = bloom.bloom(gbuf.emissive, cfg.bloom_mip_count)

    def ao():
        half = ssao.ssao_generate(vis.depth, gbuf.normal, g,
                                  cfg.ssao_kernel_size)
        return sampling.upsample_bilinear(ssao.ssao_blur(half), cfg.height,
                                          cfg.width)

    st["SSAO (preamble, K2, blur, upsample)"] = cuda_ms(ao, reps)
    ssao_full = ao()
    ssr_img = None
    if cfg.enable_ssr:
        def reflect(cap):
            return ssr.ssr(vis.depth, gbuf.albedo, gbuf.normal,
                           gbuf.metallic_roughness, g, compact_cap=cap)[0]
        st[f"SSR (compacted, cap {plan.ssr_cap})"] = cuda_ms(
            lambda: reflect(plan.ssr_cap), reps)
        st["SSR (dense, every pixel)"] = cuda_ms(lambda: reflect(0), reps)
        ssr_img = reflect(plan.ssr_cap)
    hw, hh = cfg.width // 2, cfg.height // 2
    quadrant = not cfg.cloud_fullscreen_rays
    qkw = dict(full_width=cfg.width if quadrant else None,
               full_height=cfg.height if quadrant else None)
    if cfg.cloud_impl == "perpixel" and batch.cloud_noise is not None:
        def march():
            half = clouds.render_clouds(g, vis.depth, batch.cloud_noise, hw,
                                        hh, **qkw)
            return sampling.upsample_bilinear(half, cfg.height, cfg.width)
        st["per-pixel cloud march + upsample"] = cuda_ms(march, 1)
        clouds_full = march()
        lut_fn = None
    elif batch.cloud_noise is not None:
        def lut_fn():
            return sky.render_sky_lut_noise(g, batch.cloud_noise)
        st["sky LUT (K6, noise texture)"] = cuda_ms(lut_fn, reps)
    else:
        def lut_fn():
            return sky.render_sky_lut_procedural(g)
        st["sky LUT (K6p, procedural noise)"] = cuda_ms(lut_fn, reps)
    if lut_fn is not None:
        lut = lut_fn()

        def lookup():
            half = clouds.sky_from_lut(g, lut, vis.depth, hw, hh, **qkw)
            return sampling.upsample_bilinear(half, cfg.height, cfg.width)

        st["sky lookup + upsample"] = cuda_ms(lookup, reps)
        clouds_full = lookup()

    def comp(volumetric=cfg.enable_volumetric_light):
        return composition.compose(
            g, vis.depth, gbuf.albedo, emissive, gbuf.normal, ssao_full,
            smap, clouds_full, enable_volumetric=volumetric,
            enable_shadow=cfg.enable_shadows,
            max_point_lights=cfg.max_point_lights,
            max_spot_lights=cfg.max_spot_lights,
            empty_shadow_map=cfg.enable_shadows
            and plan.shadow_statically_empty, shadow_crop=plan.shadow_crop)

    st["compose" + (" (shadow map)" if smap is not None else "")
       + (", volumetric light" if cfg.enable_volumetric_light else "")] = \
        cuda_ms(comp, reps)
    if cfg.enable_volumetric_light:
        st["  compose without the volumetric light"] = cuda_ms(
            lambda: comp(False), reps)
    hdr = comp()
    if cfg.composite_ssr and ssr_img is not None:
        mr = gbuf.metallic_roughness
        hdr = hdr + (ssr_img - hdr) * (mr[1] * (1.0 - mr[0]))[None]
    if cfg.enable_depth_of_field:
        st["depth of field (mip chain + 4 trilinear taps)"] = cuda_ms(
            lambda: dof.depth_of_field(hdr, vis.depth, g), reps)
        hdr = dof.depth_of_field(hdr, vis.depth, g)
    st["exposure"] = cuda_ms(
        lambda: exposure.auto_exposure(hdr, hist.exposure, g), reps)
    expo = exposure.auto_exposure(hdr, hist.exposure, g)

    def aa():
        return taa.taa(hdr, vis.depth, gbuf.velocity, hist.previous_color,
                       hist.previous_velocity, g.frame_counter)

    st["TAA (K3f)"] = cuda_ms(aa, reps)
    resolved = aa()
    st["tone_map"] = cuda_ms(lambda: tonemap.tone_map(resolved, expo, g),
                             reps)
    torch.cuda.synchronize()
    return st


def scene_phase(name, dev, card, results):
    """Build, parity, frames, timings and stage breakdown of one scene;
    fills results[kernel][name]."""
    import torch
    from soc_real_time_renderer_tpu_torch.graph import frame as fm
    from soc_real_time_renderer_tpu_torch.kernels import build as kb

    t0 = time.perf_counter()
    built = build_scene(name, dev)
    torch.cuda.synchronize()
    plan, batch = built.plan, built.batch
    path = path_of(plan, batch)
    noise = batch.cloud_noise
    log(f"[{name}] build: {batch.num_triangles} triangles, pair_cap main "
        f"{plan.main_grid.pair_cap} shadow {plan.shadow_grid.pair_cap}, "
        f"atlas {batch.atlas_packed.numel() * 4} bytes "
        f"{tuple(batch.atlas_packed.shape)}, {plan.atlas_num_materials} "
        f"materials, cloud_noise "
        f"{None if noise is None else tuple(noise.shape)}, "
        f"shadow_statically_empty={plan.shadow_statically_empty}, crop "
        f"{plan.shadow_crop}, build {time.perf_counter() - t0:.1f} s; path "
        f"{path}")
    if name == "terrain":
        check(path == ["resolve", "texsample", "ssao_taps", "taa_resolve",
                       "sky_lut_procedural"],
              "terrain runs K1, K5, K2, K3f, K6p")
    elif name in ("full_nohelmet", "full_lit_nohelmet"):
        check(plan.atlas_num_materials >= 2 and batch.cloud_noise is not None
              and plan.shadow_statically_empty,
              f"{name}: >= 2 materials, cloud noise, shadow elided")
        lit = name == "full_lit_nohelmet"
        cfg = plan.config
        slots = (128, 128) if lit else (0, 0)
        check((cfg.max_point_lights, cfg.max_spot_lights) == slots
              and ("local_lights" in path) == lit,
              f"{name}: 128 point and 128 spot lights bound and K7 on the "
              f"path, or neither: {cfg.max_point_lights}, "
              f"{cfg.max_spot_lights}, {path}")
    else:
        check(not plan.shadow_statically_empty,
              "atrium_lifted defeats the shadow emptiness proof")

    # each kernel of the path against its plain version, same inputs
    path_k, cases = kernel_cases(name, built, dev)
    check(sorted(path_k + STANDALONE) == sorted(cases),
          f"a case for each of {path_k} and {STANDALONE}")
    out_k = {}
    for k, (call, cmp, _, _, _) in cases.items():
        got = call("cuda")
        want = call("plain")
        torch.cuda.synchronize()
        err, msg, ok = cmp(got, want)
        log(f"[{name}] parity {k}: {msg}")
        check(ok, f"{name} {k} parity")
        out_k[k] = err

    # the main path: FRAMES frames through the kernels
    hist = fm.RenderHistory.create(plan.config, device=dev)
    kb.reset_launches()
    for f in range(FRAMES):
        g, mm, nm = built.frame_globals(f)
        if f == FRAMES - 1:
            last_in = (g, hist, mm, nm)
        out, hist = fm.render_frame(plan, batch, g, hist, mm, nm)
    torch.cuda.synchronize()
    counts = dict(kb.launches)
    log(f"[{name}] launches over {FRAMES} frames: {counts}")
    check(all(counts[k] == (FRAMES if k in path else 0) for k in counts),
          f"each kernel of {path} launched once per frame, no other")
    color = out.color
    cov = (out.gbuffer.depth < 1.0).float().mean().item()
    check(torch.isfinite(color).all().item(), "finite colour")
    check(int(out.overflow) == 0, f"overflow {int(out.overflow)} == 0")
    # inside the closed atrium every pixel is covered
    check(0.05 < cov <= 1.0, f"0.05 < coverage {cov} <= 1")
    check(color.std().item() > 1e-3, "the image is not constant")
    g, h7, mm, nm = last_in
    outp, _ = fm.render_frame(plan, batch, g, h7, mm, nm, impl="plain")
    frame_diff = (outp.color - color).abs().mean().item()
    smap = ""
    if out.shadow_map is not None:
        smap = (f", shadow map texels < 1.0: "
                f"{(out.shadow_map < 1.0).float().mean().item():.4f}")
    log(f"[{name}] frame {FRAMES}: colour mean {color.mean().item():.4f} "
        f"std {color.std().item():.4f}, coverage {cov:.4f}, overflow 0"
        f"{smap}, kernel vs plain colour mean abs {frame_diff:.3g} (< 1e-3)")
    check(frame_diff < 1e-3, "kernel-path frame vs plain-path frame")

    # timings: frames alternating, kernels at the frame's shapes
    def frame_fn(impl):
        return lambda: fm.render_frame(plan, batch, g, h7, mm, nm, impl=impl)

    for impl in (None, "plain"):
        frame_fn(impl)()
    torch.cuda.synchronize()
    ms = {"cuda": [], "plain": []}
    for _ in range(TIMED):   # alternating, so drift hits both alike
        ms["cuda"].append(cuda_ms(frame_fn(None), 1))
        ms["plain"].append(cuda_ms(frame_fn("plain"), 1))
    frame_k = statistics.median(ms["cuda"])
    frame_p = statistics.median(ms["plain"])
    log(f"[{name}] frame {WIDTH}x{HEIGHT}: kernel path {frame_k:.2f} ms, "
        f"plain path {frame_p:.2f} ms (median of {TIMED}) {card}; after "
        f"it: SM clock, power draw, temperature "
        f"{smi('clocks.sm,power.draw,temperature.gpu')}")

    # kernel and library times per call (cuda_ms: the wrapper's host
    # time included) and on the card alone (device_ms)
    flush = l2_flush(dev)
    for k, (call, _, (nbytes, ops), lib, bare) in cases.items():
        call("cuda")
        call("plain")
        k_ms = cuda_ms(lambda: call("cuda"), 20)
        k_dev = device_ms(lambda: call("cuda"), 20, flush)
        check(k_dev is not None, f"{k} timed on the card alone: its call "
              f"must not wait for the card")
        bare_dev = None
        if bare is not None:
            bare()
            bare_dev = device_ms(bare, 20, flush)
            check(bare_dev is not None, f"{k}'s launch timed on the card "
                  f"alone")
        p_ms = cuda_ms(lambda: call("plain"), TIMED)
        lib_ms = lib_dev = None
        if lib is not None:
            lib()
            lib_ms = cuda_ms(lib, 20)
            lib_dev = device_ms(lib, 20, flush)
            check(lib_dev is not None, f"{k}'s library call timed on the "
                  f"card alone")
        b_ms, b_by = bound(nbytes, ops)

        def shown(call_ms, dev_ms):
            return f"{call_ms:.4f} ms per call, on the card {dev_ms:.4f} ms"

        launch = ("" if bare_dev is None else
                  f" (its launch alone {bare_dev:.4f} ms)")
        log(f"[{name}] {k}: kernel {shown(k_ms, k_dev)}{launch}, plain "
            f"{p_ms:.4f} "
            f"ms, bound {b_ms:.4f} ms by {b_by} ({nbytes} bytes, {ops} ops),"
            f" library {'none' if lib is None else shown(lib_ms, lib_dev)}"
            f" {card}")
        results.setdefault(k, {})[name] = {
            "launches": counts[k], "max_abs_err": out_k[k], "ms": k_ms,
            "device_ms": k_dev, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms,
            "library_device_ms": lib_dev, "launch_device_ms": bare_dev}
    del flush

    st = stage_table(built, g, h7, mm, nm)
    log(f"[{name}] stages (kernel path, ms, median of 3) {card}:")
    for s, v in st.items():
        log(f"[{name}]   {s}: {v:.2f}")
    del built, out, outp, hist
    torch.cuda.empty_cache()
    return frame_k, frame_p


def run_frames(built, plan, path, n, dev):
    """`n` frames through render_frame with the launch counts set to 0
    just before and read just after: each kernel of `path` must have
    launched once per frame, the others never.  Returns (last outputs,
    the last frame's inputs (g, history, mm, nm), counts)."""
    import torch
    from soc_real_time_renderer_tpu_torch.graph import frame as fm
    from soc_real_time_renderer_tpu_torch.kernels import build as kb
    hist = fm.RenderHistory.create(plan.config, device=dev)
    kb.reset_launches()
    for f in range(n):
        g, mm, nm = built.frame_globals(f)
        last_in = (g, hist, mm, nm)
        out, hist = fm.render_frame(plan, built.batch, g, hist, mm, nm)
    torch.cuda.synchronize()
    counts = dict(kb.launches)
    check(all(counts[k] == (n if k in path else 0) for k in counts),
          f"each kernel of {path} launched once per frame of {n}, no other: "
          f"{counts}")
    return out, last_in, counts


def passes_phase(dev, card, results):
    """`atrium_passes`: SSR (K8, composited), depth of field and the
    volumetric light over the rendered 4096^2 shadow map; K8 against its
    plain version on the frame's own targets, timed beside its bound."""
    import dataclasses
    import torch
    from soc_real_time_renderer_tpu_torch.graph import frame as fm
    from soc_real_time_renderer_tpu_torch.ops import ssr
    name = "atrium_passes"
    built = build_scene(name, dev)
    plan, batch = built.plan, built.batch
    cfg = plan.config
    path = path_of(plan, batch)
    check(sorted(path) == sorted(NOISE_PATH + SSR),
          f"{name} runs the six kernels of the noise path and K8: {path}")
    P = WIDTH * HEIGHT
    check(plan.ssr_cap == P, f"the screen's cap: {plan.ssr_cap} == {P}")

    def frame(g, hist, mm, nm, cap, impl=None, **off):
        pl = dataclasses.replace(plan, ssr_cap=cap,
                                 config=cfg.replace(**off))
        return fm.render_frame(pl, batch, g, hist, mm, nm, impl=impl)[0]

    out, (g, hist, mm, nm), counts = run_frames(built, plan, path,
                                                PASS_FRAMES, dev)
    for k in counts:
        results.setdefault(k, {})[name] = {"launches": counts[k]}
    metal = out.gbuffer.metallic_roughness[1] >= ssr.METALLIC_MIN
    n_active = int(out.ssr_active)
    hits = int((out.ssr[:, metal] != 0).any(0).sum())
    # the cap _finish sizes by default (5% of the screen rounded up to
    # 1,024, the JAX package's rule) is below this scene's reflective
    # pixels, as it would be in the reference: it sets bit 16
    scap = -(-int(0.05 * P) // 1024) * 1024
    over = frame(g, hist, mm, nm, scap)
    check(scap < n_active and int(over.overflow) & ssr.OVERFLOW_SSR_CAP,
          f"_finish's default ssr_cap {scap} sets bit 16 under {n_active} "
          f"reflective pixels")
    del over
    log(f"[{name}] launches over {PASS_FRAMES} frames: {counts}; frame "
        f"{PASS_FRAMES}: ssr_active {n_active} of {P} ({n_active / P:.4f};"
        f" _finish's default cap {scap} sets bit 16, the screen's cap "
        f"{plan.ssr_cap} none), overflow {int(out.overflow)}, reflective "
        f"pixels whose ray found a hit: {hits}")
    check(n_active == int(metal.sum()) > 0.01 * P,
          "ssr_active counts the metal")
    check(int(out.overflow) == 0, f"overflow {int(out.overflow)} == 0")
    check(hits > 0, "some reflective pixel found a hit")
    check(all(torch.isfinite(t).all().item()
              for t in (out.color, out.hdr, out.ssr)), "finite outputs")

    dense = frame(g, hist, mm, nm, 0)
    check(int(dense.ssr_active) == -1 and torch.equal(dense.ssr, out.ssr)
          and torch.equal(dense.color, out.color),
          "the capped frame equals the dense frame bit for bit")
    half = frame(g, hist, mm, nm, n_active // 2)
    differs = (half.ssr != out.ssr).any(0)
    check(int(half.overflow) & ssr.OVERFLOW_SSR_CAP
          and int(half.ssr_active) == n_active,
          "a cap at half of the reflective pixels sets bit 16")
    check(differs.any().item() and metal[differs].all().item()
          and (half.ssr[:, differs] == 0).all().item(),
          "over the cap only reflective pixels change, to black")
    changed = {}
    for off in ("enable_depth_of_field", "enable_volumetric_light",
                "composite_ssr"):
        other = frame(g, hist, mm, nm, P, **{off: False})
        changed[off] = (other.hdr - out.hdr).abs().mean().item()
        check(not torch.equal(other.hdr, out.hdr)
              and torch.isfinite(other.color).all().item(),
              f"{off} changes the frame")
    default = frame(g, hist, mm, nm, 0, enable_ssr=False,
                    composite_ssr=False, enable_depth_of_field=False,
                    enable_volumetric_light=False)
    check(default.ssr is None
          and (torch.isfinite(out.color) | ~torch.isfinite(default.color))
          .all().item(), "finite wherever the default frame is")
    plain = frame(g, hist, mm, nm, P, impl="plain")
    diff = (plain.color - out.color).abs().mean().item()
    log(f"[{name}] capped == dense; half cap: bit 16, "
        f"{int(differs.sum())} pixels black; hdr mean abs moved by each "
        f"switch {changed}; kernel vs plain colour mean abs {diff:.3g} "
        f"(< 1e-3)")
    check(diff < 1e-3, "kernel-path frame vs plain-path frame")
    del dense, half, default, plain

    # K8 on the frame's own targets against its plain version: the
    # dense march, caps past and under the reflective pixels, the screen
    gbuf = out.gbuffer
    targets = (gbuf.depth, gbuf.albedo, gbuf.normal,
               gbuf.metallic_roughness)
    errs = {}
    for cap in (0, n_active + 100, n_active // 2, P):
        call, cmp, (nbytes, ops), _, _ = ssr_case(targets, g, cap)
        got, want = call("cuda"), call("plain")
        torch.cuda.synchronize()
        errs[cap], msg, ok = cmp(got, want)
        log(f"[{name}] parity ssr_march: {msg}")
        check(ok, f"{name} ssr_march parity, cap {cap}")
    flush = l2_flush(dev)
    k_ms = cuda_ms(lambda: call("cuda"), 20)
    k_dev = device_ms(lambda: call("cuda"), 20, flush)
    check(k_dev is not None, "ssr_march timed on the card alone: its call "
          "must not wait for the card")
    p_ms = cuda_ms(lambda: call("plain"), TIMED)
    del flush
    b_ms, b_by = bound(nbytes, ops)
    log(f"[{name}] ssr_march: kernel {k_ms:.4f} ms per call, on the card "
        f"{k_dev:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms by "
        f"{b_by} ({nbytes} bytes, {ops} ops), library none {card}")
    results["ssr_march"][name].update(
        max_abs_err=max(errs.values()), ms=k_ms, device_ms=k_dev,
        plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        library_device_ms=None, launch_device_ms=None)
    st = stage_table(built, g, hist, mm, nm)
    log(f"[{name}] stages (kernel path, ms, median of 3) {card}:")
    for s, v in st.items():
        log(f"[{name}]   {s}: {v:.2f}")
    del built, out
    torch.cuda.empty_cache()
    return st["whole frame"]


def perpixel_phase(dev, card, results):
    """`terrain_perpixel`: the exact cloud march at every half-res pixel
    instead of the sky LUT."""
    import dataclasses
    import torch
    from soc_real_time_renderer_tpu_torch.graph import frame as fm
    from soc_real_time_renderer_tpu_torch.ops import clouds
    name = "terrain_perpixel"
    built = build_scene(name, dev)
    plan, batch = built.plan, built.batch
    path = path_of(plan, batch)
    check(path == ["resolve", "texsample", "ssao_taps", "taa_resolve"],
          f"{name} runs K1, K5, K2, K3f and neither K6 nor K6p: {path}")
    out, (g, hist, mm, nm), counts = run_frames(built, plan, path,
                                                PASS_FRAMES, dev)
    for k in counts:
        results[k][name] = {"launches": counts[k]}
    clear = clouds._vec([0.2, 0.4, 1.0], dev)[:, None, None]
    sky_px = (out.clouds != clear).any(0)
    sky = sky_px.float().mean().item()
    check(sky >= 0.1, f"{sky:.4f} of the half-res pixels are sky (>= 0.1)")
    check(torch.isfinite(out.clouds[:, sky_px]).all().item()
          and torch.isfinite(out.color).all().item()
          and int(out.overflow) == 0, "finite clouds and colour")
    # the LUT path's frame of the same globals and history
    lut_plan = dataclasses.replace(
        plan, config=plan.config.replace(cloud_impl="lut"))
    lut = fm.render_frame(lut_plan, batch, g, hist, mm, nm)[0]
    peak = out.clouds[:, sky_px].max().item()
    d = (lut.clouds - out.clouds)[:, sky_px].abs()
    mean, worst = d.mean().item() / peak, d.max().item() / peak
    cdiff = (lut.color - out.color).abs().mean().item()
    log(f"[{name}] launches over {PASS_FRAMES} frames: {counts}; sky "
        f"{sky:.4f} of the half-res pixels; LUT path against per-pixel on "
        f"the sky pixels of the clouds target: mean abs {mean:.5f} "
        f"(<= {LUT_MEAN_BOUND}), worst pixel {worst:.4f} of the peak sky "
        f"luminance {peak:.4f}; colour mean abs {cdiff:.3g}")
    check(mean <= LUT_MEAN_BOUND,
          "the LUT path stays within the pinned bound of the per-pixel "
          "march")
    st = stage_table(built, g, hist, mm, nm, reps=1)
    log(f"[{name}] stages (kernel path, ms, one run each) {card}:")
    for s, v in st.items():
        log(f"[{name}]   {s}: {v:.2f}")
    del built, out, lut
    torch.cuda.empty_cache()
    return st["whole frame"]


def recorded_inputs(fn, every=False):
    """fn() with every kernel wrapper spied: {kernel: (wrapper, args,
    kwargs without impl)} of each wrapper's first call (every: a list of
    every call's)."""
    from soc_real_time_renderer_tpu_torch.ops import raster2, sky, ssao, \
        ssr, taa, texsample
    wrappers = {"resolve": (raster2, "resolve"),
                "resolve_depth": (raster2, "resolve_depth"),
                "texsample": (texsample, "sample_atlas"),
                "ssao_taps": (ssao, "ssao_taps"),
                "sky_lut": (sky, "render_sky_lut_noise"),
                "sky_lut_procedural": (sky, "render_sky_lut_procedural"),
                "taa_reproject": (taa, "reproject_history"),
                "taa_resolve": (taa, "_resolve"),
                "ssr_march": (ssr, "ssr")}
    seen, real = {}, {}
    for k, (mod, attr) in wrappers.items():
        real[k] = getattr(mod, attr)

        def spy(*a, _k=k, **kw):
            call = (real[_k], a, {n: v for n, v in kw.items()
                                  if n != "impl"})
            if every:
                seen.setdefault(_k, []).append(call)
            else:
                seen.setdefault(_k, call)
            return real[_k](*a, **kw)

        setattr(mod, attr, spy)
    try:
        fn()
    finally:
        for k, (mod, attr) in wrappers.items():
            setattr(mod, attr, real[k])
    return seen


def batched_phase(name, dev, card, results):
    """B = len(BATCH_POSITIONS[name]) views of `name` in one step: launch
    counts over BATCH_FRAMES batched frames, each view against its
    single-view frame, each kernel against its plain version on the
    batched inputs, batched against single-view frame ms, peak memory at
    B = 1 and B.  On the scenes of the passes that are off by default,
    also each of those passes in one call for the B views against B
    single-view calls (ms, and the CUDA kernels counted with
    torch.profiler).  Returns (batched ms, single-view ms, peak MiB
    B = 1, peak MiB B)."""
    import dataclasses
    import torch
    from soc_real_time_renderer_tpu_torch.config import SunInfo
    from soc_real_time_renderer_tpu_torch.graph import frame as fm
    from soc_real_time_renderer_tpu_torch.kernels import build as kb
    from soc_real_time_renderer_tpu_torch.parallel import mesh as pmesh
    built = build_scene(name, dev)
    plan, batch = built.plan, built.batch
    path = path_of(plan, batch)
    positions = BATCH_POSITIONS[name]
    B = len(positions)

    def histories(n):
        return pmesh.batched_history([fm.RenderHistory.create(
            plan.config, device=dev) for _ in range(n)])

    step = pmesh.make_batched_render_fn(plan)

    if name.startswith("terrain"):
        check(plan.shadow_statically_empty and "sky_lut" not in path
              and ("sky_lut_procedural" in path) == (name == "terrain"),
              f"{name}: the shadow elided, no K6 (K6p, the procedural LUT, "
              f"or the per-pixel march)")
    if name == "terrain":
        gs, mm, nm = pmesh.view_globals(built, positions, 0)
        gs[1] = dataclasses.replace(gs[1], sun=SunInfo.create(
            angle_direction_deg=(12.0, 0.0, 0.0), device=dev))
        kb.reset_launches()
        try:
            step(batch, pmesh.batched_globals(gs), histories(B), mm, nm)
            refused = False
        except ValueError:
            refused = True
        check(refused and not any(kb.launches.values()),
              "a batch with one view under another sun is refused before "
              "any launch")
    elif not name.startswith("terrain"):
        check(not plan.shadow_statically_empty
              and plan.shadow_crop is not None
              and sorted(path) == sorted(
                  NOISE_PATH + (SSR if name == "atrium_passes" else [])),
              f"{name}: the shadow paid through its crop, all six kernels"
              f" (and K8 in atrium_passes)")

    # BATCH_FRAMES consecutive batched frames, the launch counts around them
    hb = histories(B)
    frames, prev = [], None
    kb.reset_launches()
    for f in range(BATCH_FRAMES):
        gs, mm, nm = pmesh.view_globals(built, positions, f, prev)
        prev = [g.camera for g in gs]
        hb_in = hb
        colors, hb = step(batch, pmesh.batched_globals(gs), hb, mm, nm)
        frames.append((colors, hb, gs, hb_in))
    torch.cuda.synchronize()
    counts = dict(kb.launches)
    log(f"[batched {name}] {B} views, launches over {BATCH_FRAMES} batched "
        f"frames: {counts}")
    check(all(counts[k] == (BATCH_FRAMES if k in path else 0)
              for k in counts),
          f"each kernel of {path} launched once per batched frame of {B} "
          f"views, no other")
    for k in counts:
        results[k][f"batched {name}"] = {"launches": counts[k]}
    colors = frames[-1][0]
    check(colors.shape == (B, 3, HEIGHT, WIDTH)
          and torch.isfinite(colors).all().item(), "finite (B, 3, H, W)")
    spread = min((colors[i] - colors[j]).abs().mean().item()
                 for i in range(B) for j in range(i))
    check(spread > 1e-3, f"the {B} views are distinct images ({spread:.4g})")

    # view i of each batched frame against render_frame of view i
    hs = [fm.RenderHistory.create(plan.config, device=dev)
          for _ in range(B)]
    worst = {"colour": 0.0, "history colour": 0.0, "exposure": 0.0}
    overflow = []
    for colors_f, hb_f, gs, _ in frames:
        for i in range(B):
            out, hs[i] = fm.render_frame(plan, batch, gs[i], hs[i], mm, nm)
            overflow.append(int(out.overflow))
            for key, (a, b) in {
                    "colour": (out.color, colors_f[i]),
                    "history colour": (hs[i].previous_color,
                                       hb_f.previous_color[i]),
                    "exposure": (hs[i].exposure, hb_f.exposure[i])}.items():
                worst[key] = max(worst[key], (a.float() - b.float()).abs()
                                 .max().item())
    torch.cuda.synchronize()
    log(f"[batched {name}] view i of {BATCH_FRAMES} batched frames against "
        f"render_frame of view i, max abs: " + ", ".join(
            f"{k} {v:.3g}" for k, v in worst.items()) + " (<= 1e-6); "
        f"overflow bits of each single frame {overflow}")
    check(not any(overflow), "no view overflows the static caps")
    check(max(worst.values()) <= 1e-6, "each view equals its single frame")

    # each kernel against its plain version on the last frame's inputs
    colors_l, _, gs_l, hb_l = frames[-1]
    gb_l = pmesh.batched_globals(gs_l)
    plain_step = pmesh.make_batched_render_fn(plan, impl="plain")
    seen = recorded_inputs(lambda: plain_step(batch, gb_l, hb_l, mm, nm))
    check(sorted(seen) == sorted(path), f"inputs recorded for {path}")
    for k, (fn, a, kw) in seen.items():
        got, want = fn(*a, impl="cuda", **kw), fn(*a, impl="plain", **kw)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max((x.float() - y.float()).abs().max().item()
                  for x, y in zip(got, want))
        same = all(torch.equal(x, y) for x, y in zip(got, want))
        log(f"[batched {name}] parity {k}: {tuple(got[0].shape)}, max abs "
            f"{err:.3g} (== 0), equal {same}")
        check(same and err == 0.0, f"batched {name} {k} parity")
    del seen
    if name in ("atrium_passes", "terrain_perpixel"):
        batched_passes(name, plan, batch, gb_l, gs_l, hb_l, mm, nm, card)

    # batched frame against four single-view frames, alternating
    def batched():
        step(batch, gb_l, hb_l, mm, nm)

    def singles():
        for i in range(B):
            fm.render_frame(plan, batch, gs_l[i], hs[i], mm, nm)

    batched()
    singles()
    torch.cuda.synchronize()
    ms = {"batched": [], "singles": []}
    for _ in range(TIMED):
        ms["batched"].append(cuda_ms(batched, 1))
        ms["singles"].append(cuda_ms(singles, 1))
    b_ms = statistics.median(ms["batched"])
    s_ms = statistics.median(ms["singles"])

    # peak device memory of one batched frame at B = 1 and at B
    peak = {}
    for n in (1, B):
        gb_n = pmesh.batched_globals(gs_l[:n])
        hb_n = histories(n)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        step(batch, gb_n, hb_n, mm, nm)
        torch.cuda.synchronize()
        peak[n] = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    log(f"[batched {name}] {WIDTH}x{HEIGHT}, {B} views: batched frame "
        f"{b_ms:.2f} ms against {B} single-view frames {s_ms:.2f} ms "
        f"({s_ms / B:.2f} ms each; median of {TIMED}, alternating); peak "
        f"device memory of a batched frame (max_memory_allocated, the "
        f"scene's own tensors included): B = 1 {peak[1]:.0f} MiB, B = {B} "
        f"{peak[B]:.0f} MiB {card}")
    del built, frames, colors, colors_l, hb, hb_l, gb_l
    torch.cuda.empty_cache()
    return b_ms, s_ms, peak[1], peak[B]


def batched_passes(name, plan, batch, gb, gs, hb, mm, nm, card):
    """The passes that are off by default on a batched frame's own
    inputs: each in one call for the B views against B single-view calls
    (ms, CUDA events, median of TIMED, alternating), and the CUDA
    kernels each issues at B and at B = 1 (torch.profiler): SSR, depth
    of field and the volumetric term about as many at B as at 1.  The
    cloud march's chunk loop runs over (view, row), so its kernels grow
    with the rows: its chunks are printed instead."""
    import torch
    from soc_real_time_renderer_tpu_torch.graph import frame as fm
    from soc_real_time_renderer_tpu_torch.ops import clouds, composition, \
        dof, ssr
    cfg = plan.config
    B = len(gs)
    out = fm.render_frame(plan, batch, gb, hb, mm, nm)[0]
    gbuf = out.gbuffer
    if name == "atrium_passes":
        imgs = (gbuf.depth, gbuf.albedo, gbuf.normal,
                gbuf.metallic_roughness)
        comp = (gbuf.depth, gbuf.albedo, gbuf.emissive, gbuf.normal,
                torch.ones_like(gbuf.depth), out.shadow_map, None)
        ckw = dict(enable_volumetric=True,
                   max_point_lights=cfg.max_point_lights,
                   max_spot_lights=cfg.max_spot_lights,
                   shadow_crop=plan.shadow_crop)
        passes = {
            "SSR": lambda g, *a: ssr.ssr(*a, g, compact_cap=plan.ssr_cap),
            "depth of field": lambda g, *a: dof.depth_of_field(*a, g),
            "compose with the volumetric light":
                lambda g, *a: composition.compose(g, *a, **ckw)}
        args = {"SSR": imgs, "depth of field": (out.hdr, gbuf.depth),
                "compose with the volumetric light": comp}
    else:
        hw, hh = cfg.width // 2, cfg.height // 2
        passes = {"per-pixel cloud march": lambda g, d: clouds.render_clouds(
            g, d, batch.cloud_noise, hw, hh, full_width=cfg.width,
            full_height=cfg.height)}
        args = {"per-pixel cloud march": (gbuf.depth,)}
    for pname, fn in passes.items():
        a = args[pname]

        def batched(fn=fn, a=a):
            return fn(gb, *a)

        def singles(fn=fn, a=a):
            return [fn(gs[i], *(None if x is None else x[i] for x in a))
                    for i in range(B)]

        got = batched()
        got = got if isinstance(got, tuple) else (got,)
        worst = 0.0
        for i, one in enumerate(singles()):
            one = one if isinstance(one, tuple) else (one,)
            worst = max([worst] + [(x[i].float() - y.float()).abs().max()
                                   .item() for x, y in zip(got, one)])
        check(worst == 0.0, f"{pname}: each view of the batched call "
              f"equals its single-view call bit for bit ({worst:.3g})")
        ms = {"batched": [], "singles": []}
        for _ in range(TIMED):
            ms["batched"].append(cuda_ms(batched, 1))
            ms["singles"].append(cuda_ms(singles, 1))
        if pname == "per-pixel cloud march":
            # its kernels grow with the chunks (tracing its ~120,000 at
            # B = 4 costs a minute): the chunks are the count
            chunks = [-(-n * cfg.height // 2 // 64) for n in (B, 1)]
            kernels = (f"chunks of 64 (view, row) rows at B = {B} "
                       f"{chunks[0]}, at B = 1 {chunks[1]}")
        else:
            k_b, k_1 = cuda_kernels(batched), cuda_kernels(
                lambda fn=fn, a=a: fn(gs[0], *(None if x is None else x[0]
                                               for x in a)))
            kernels = (f"CUDA kernels (torch.profiler) at B = {B} {k_b}, "
                       f"at B = 1 {k_1}, ratio {k_b / max(k_1, 1):.3f}")
            check(k_1 > 0 and k_b <= SSR_LAUNCH_RATIO * k_1,
                  f"{pname}: the kernels of {B} views <= "
                  f"{SSR_LAUNCH_RATIO} x one view's")
        log(f"[batched {name}] {pname}: one call for {B} views "
            f"{statistics.median(ms['batched']):.2f} ms against {B} "
            f"single-view calls {statistics.median(ms['singles']):.2f} ms "
            f"(median of {TIMED}, alternating); {kernels}; each view equal "
            f"to its single call {card}")
    del out, gbuf
    torch.cuda.empty_cache()


def sharded_phase(dev, card, results):
    """`atrium_lifted` (all six kernels) cut into SHARD_BANDS row bands
    over a mesh that names the card SHARD_BANDS times
    (``parallel/mesh.make_mesh`` + ``raster_stage`` of the split plan +
    ``make_sharded_shade_fn``), SHARD_FRAMES frames carrying history:
    launch counts per frame (K1, K4, K5, K2, K3f once per band, K6 once:
    one distinct device); the assembled colour, history and exposure
    against the unsplit frames; every band-mode launch against its plain
    version on the band's inputs (recorded during a plain-path split
    frame); ms per frame split and unsplit (CUDA events, alternating);
    max_memory_allocated of a frame at sp = 1 and sp = SHARD_BANDS.
    Then the meshed batched step: the terrain's four views over a
    (dp = 2, sp = 2) mesh of the card against the unmeshed batched step.
    Returns (split ms, unsplit ms, peak MiB sp = 1, peak MiB split,
    launches per split frame)."""
    import dataclasses
    import torch
    from soc_real_time_renderer_tpu_torch.graph import frame as fm
    from soc_real_time_renderer_tpu_torch.kernels import build as kb
    from soc_real_time_renderer_tpu_torch.parallel import halo
    from soc_real_time_renderer_tpu_torch.parallel import mesh as pmesh
    built = build_scene("atrium_lifted", dev)
    plan, batch = built.plan, built.batch
    path = path_of(plan, batch)
    check(sorted(path) == NOISE_PATH, "atrium_lifted runs all six")
    n = SHARD_BANDS
    mesh = pmesh.make_mesh(n, dp=1, devices=[dev] * n)
    splan = dataclasses.replace(plan, shard_mesh=mesh, shard_axis="sp")
    starts = halo.band_starts(HEIGHT, n)

    def split(g, h, mm, nm, impl=None):
        ins = fm.raster_stage(splan, batch, g, mm, nm, impl=impl)
        return pmesh.make_sharded_shade_fn(plan, mesh, impl=impl)(
            batch, g, h, *ins)

    # the main path: SHARD_FRAMES split frames, counts around each
    hs = hu = fm.RenderHistory.create(plan.config, device=dev)
    per_frame, worst, frames = [], {}, []
    for f in range(SHARD_FRAMES):
        g, mm, nm = built.frame_globals(f)
        h_in, hu_in = hs, hu
        torch.cuda.synchronize()
        kb.reset_launches()
        colour, hs = split(g, hs, mm, nm)
        torch.cuda.synchronize()
        per_frame.append(dict(kb.launches))
        out, hu = fm.render_frame(plan, batch, g, hu, mm, nm)
        frames.append((g, h_in, hu_in, mm, nm))
        for key, (a, b) in {
                "colour": (out.color, colour),
                "history colour": (hu.previous_color, hs.previous_color),
                "history velocity": (hu.previous_velocity,
                                     hs.previous_velocity)}.items():
            got = halo.assemble(b, dev)
            worst[key] = max(worst.get(key, 0.0),
                             (a.float() - got.float()).abs().max().item())
        worst["exposure"] = max(worst.get("exposure", 0.0),
                                (hu.exposure - hs.exposure).abs().item())
        check([c.shape[-2] for c in colour] == [b - a for a, b in
                                                zip(starts, starts[1:])]
              and all(c.device == dev for c in colour),
              f"{n} colour bands of {starts}")
    want = {k: (1 if k == "sky_lut" else n if k in path else 0)
            for k in KERNELS}
    log(f"[sharded] atrium_lifted {WIDTH}x{HEIGHT} in {n} row bands "
        f"{starts} over {[str(d) for d in mesh.band_devices('sp')]}: "
        f"launches per frame {per_frame} (want {want}: once per band, K6 "
        f"once per distinct device)")
    check(all(c == want for c in per_frame), "launches once per band")
    for k in KERNELS:
        results[k]["sharded atrium_lifted"] = {
            "launches": sum(c[k] for c in per_frame)}
    colour_full = halo.assemble(colour, dev)
    check(torch.isfinite(colour_full).all().item()
          and colour_full.std().item() > 1e-3, "finite, not constant")
    log(f"[sharded] assembled against the unsplit frames over "
        f"{SHARD_FRAMES} frames, max abs: " + ", ".join(
            f"{k} {v:.3g}" for k, v in worst.items())
        + " (colour and history <= 1e-6, exposure <= 1e-7) " + card)
    check(max(v for k, v in worst.items() if k != "exposure") <= 1e-6
          and worst["exposure"] <= 1e-7, "split frame equals unsplit")

    # each band-mode launch against its plain version on its inputs
    g, h_in, hu_in, mm, nm = frames[-1]
    seen = recorded_inputs(lambda: split(g, h_in, mm, nm, impl="plain"),
                           every=True)
    check({k: len(v) for k, v in seen.items()}
          == {k: c for k, c in want.items() if c},
          f"inputs recorded for every band: "
          f"{ {k: len(v) for k, v in seen.items()} }")
    parity = {}
    for k, calls in seen.items():
        errs, shapes = [], []
        for fn, a, kw in calls:
            got, exp = fn(*a, impl="cuda", **kw), fn(*a, impl="plain", **kw)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            exp = exp if isinstance(exp, tuple) else (exp,)
            shapes.append(tuple(got[0].shape))
            errs.append(max((x.float() - y.float()).abs().max().item()
                            for x, y in zip(got, exp)))
            check(all(torch.equal(x, y) for x, y in zip(got, exp)),
                  f"sharded {k} parity, band {len(errs) - 1}")
        parity[k] = max(errs)
        log(f"[sharded] parity {k}: {len(calls)} launches, out {shapes}, "
            f"row0 {[kw.get('row0') for _, _, kw in calls]}, max abs "
            f"{parity[k]:.3g} (== 0), equal True")
        results[k]["sharded atrium_lifted"]["max_abs_err"] = parity[k]
    del seen

    # ms per frame, split and unsplit, alternating
    def split_frame():
        split(g, h_in, mm, nm)

    def whole_frame():
        fm.render_frame(plan, batch, g, hu_in, mm, nm)

    split_frame()
    whole_frame()
    torch.cuda.synchronize()
    ms = {"split": [], "whole": []}
    for _ in range(TIMED):
        ms["split"].append(cuda_ms(split_frame, 1))
        ms["whole"].append(cuda_ms(whole_frame, 1))
    s_ms, w_ms = (statistics.median(ms[k]) for k in ("split", "whole"))
    peak = {}
    for key, fn in (("1", whole_frame), (str(n), split_frame)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        fn()
        torch.cuda.synchronize()
        peak[key] = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    log(f"[sharded] {WIDTH}x{HEIGHT}: frame in {n} bands on one card "
        f"{s_ms:.2f} ms against unsplit {w_ms:.2f} ms (median of {TIMED}, "
        f"alternating; the bands run one after another on the one card); "
        f"peak device memory of a frame (max_memory_allocated, the scene's "
        f"own tensors included): sp = 1 {peak['1']:.0f} MiB, sp = {n} "
        f"{peak[str(n)]:.0f} MiB {card}")
    del built, frames, colour, colour_full, hs, hu, out
    torch.cuda.empty_cache()

    # the passes that are off by default in bands: atrium_passes, its
    # SSR, DoF and per-band volumetric term on the split frame
    built = build_scene("atrium_passes", dev)
    plan = built.plan
    splan = dataclasses.replace(plan, shard_mesh=mesh, shard_axis="sp")
    hs = hu = fm.RenderHistory.create(plan.config, device=dev)
    per_frame_p, worst_p = [], {}
    for f in range(SHARD_FRAMES):
        g, mm, nm = built.frame_globals(f)
        torch.cuda.synchronize()
        kb.reset_launches()
        so, hs = fm.render_frame(splan, built.batch, g, hs, mm, nm)
        torch.cuda.synchronize()
        per_frame_p.append(dict(kb.launches))
        uo, hu = fm.render_frame(plan, built.batch, g, hu, mm, nm)
        check(int(so.ssr_active) == int(uo.ssr_active) > 0
              and int(so.overflow) == int(uo.overflow) == 0,
              f"split ssr_active {int(so.ssr_active)} == unsplit "
              f"{int(uo.ssr_active)}, no overflow")
        for key, (a, b) in {
                "colour": (uo.color, halo.assemble(so.color, dev)),
                "hdr": (uo.hdr, halo.assemble(so.hdr, dev)),
                "SSR target": (uo.ssr, so.ssr),
                "history colour": (hu.previous_color,
                                   halo.assemble(hs.previous_color, dev)),
                "exposure": (hu.exposure, hs.exposure)}.items():
            worst_p[key] = max(worst_p.get(key, 0.0),
                               (a.float() - b.float()).abs().max().item())
    for k in KERNELS:
        results[k]["sharded atrium_passes"] = {
            "launches": sum(c[k] for c in per_frame_p)}
    log(f"[sharded] atrium_passes (SSR cap {plan.ssr_cap}, DoF, volumetric "
        f"light) in {n} row bands, {SHARD_FRAMES} frames: launches per "
        f"frame {per_frame_p}; against the unsplit frames, max abs: "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst_p.items())
        + f" (<= 1e-6) {card}")
    # K8 once a frame: SSR runs on the gathered screen
    check(all(c == dict(want, ssr_march=1) for c in per_frame_p),
          "atrium_passes split: launches once per band, K8 once")
    check(max(worst_p.values()) <= 1e-6,
          "split atrium_passes equals unsplit")
    del built, so, uo, hs, hu
    torch.cuda.empty_cache()

    # the meshed batched step: 4 views of the terrain, (dp 2, sp 2)
    built = build_scene("terrain", dev)
    positions = BATCH_POSITIONS["terrain"]
    B = len(positions)
    mesh = pmesh.make_mesh(4, dp=2, devices=[dev] * 4)
    meshed = pmesh.make_batched_render_fn(built.plan, mesh=mesh)
    step = pmesh.make_batched_render_fn(built.plan)
    hb = hm = pmesh.batched_history([fm.RenderHistory.create(
        built.plan.config, device=dev) for _ in range(B)])
    prev, worst_m, counts = None, 0.0, []
    for f in range(BATCH_FRAMES):
        gs, mm, nm = pmesh.view_globals(built, positions, f, prev)
        prev = [g.camera for g in gs]
        gb = pmesh.batched_globals(gs)
        bt = built.batch
        if f == 0:
            bt, gm, hm = pmesh.shard_inputs(mesh, built.batch, gb, hm)
        else:
            gm = gb
        torch.cuda.synchronize()
        kb.reset_launches()
        colors_m, hm = meshed(bt, gm, hm, mm, nm)
        torch.cuda.synchronize()
        counts.append(dict(kb.launches))
        colors, hb = step(built.batch, gb, hb, mm, nm)
        got = pmesh.assemble_views(colors_m, dev)
        hist = pmesh.assemble_history(hm, dev)
        check(got.shape == colors.shape == (B, 3, HEIGHT, WIDTH),
              "meshed colour (B, 3, H, W)")
        for a, b in ((colors, got), (hb.previous_color, hist.previous_color),
                     (hb.exposure, hist.exposure)):
            worst_m = max(worst_m, (a.float() - b.float()).abs().max()
                          .item())
    log(f"[sharded] terrain, {B} views over a (dp 2, sp 2) mesh of the "
        f"card, {BATCH_FRAMES} frames: launches per step {counts} (K1, K5, "
        f"K2, K3f once per band of each group, K6p once per group); each "
        f"view against the unmeshed batched step, max abs {worst_m:.3g} "
        f"(<= 1e-6) {card}")
    path_t = path_of(built.plan, built.batch)
    # the sky LUT once per distinct device of each view group
    check(all(c == {k: ((2 if k.startswith("sky_lut") else 4)
                        if k in path_t else 0) for k in KERNELS}
              for c in counts),
          "the meshed step launches once per band of each view group")
    check(worst_m <= 1e-6, "meshed views equal the unmeshed step")
    del built, hb, hm, colors, colors_m, got, hist
    torch.cuda.empty_cache()
    return s_ms, w_ms, peak["1"], peak[str(n)], per_frame[-1]


def asset_phase(tree, card):
    """Writes the synthetic asset tree at the real assets' sizes
    (tools/synth_assets.py: a 15,480-triangle helmet with five 2048^2
    maps, Sponza's fifteen 1024^2 maps, the 64^2 noise PNG), then loads
    the helmet, decodes every map by hand and packs the helmet's atlas:
    the seconds of each; whether PIL imports here, and where it does,
    decode_png against PIL on every map."""
    import glob
    import io
    from soc_real_time_renderer_tpu_torch.models import gltf, texture
    from soc_real_time_renderer_tpu_torch.tools import synth_assets
    from soc_real_time_renderer_tpu_torch.utils import png
    sec = {}
    t0 = time.perf_counter()
    paths = synth_assets.write_asset_tree(tree, seed=ASSET_SEED)
    sec["write"] = time.perf_counter() - t0
    maps = sorted(glob.glob(os.path.join(tree, "*", "glTF", "*.png")))
    blobs = []
    for m in maps:
        with open(m, "rb") as f:
            blobs.append(f.read())
    t0 = time.perf_counter()
    model = gltf.load_model(paths["helmet"])
    sec["load_model"] = time.perf_counter() - t0
    check(len(model.triangles) == 15_480
          and [img.shape for img in model.images] == [(2048, 2048, 4)] * 5,
          "the helmet: 15,480 triangles, five 2048^2 maps")
    t0 = time.perf_counter()
    decoded = [png.decode_png(b) for b in blobs]
    sec["decode_png"] = time.perf_counter() - t0
    check(png.load() is not None, "g++ built the PNG unfilter")
    try:
        import PIL
        from PIL import Image
        pil = f"PIL {PIL.__version__} imports"
    except ImportError:
        pil = None
    if pil is not None:
        t0 = time.perf_counter()
        for b, d in zip(blobs, decoded):
            with Image.open(io.BytesIO(b)) as im:
                check(np.asarray(im.convert("RGBA")).tobytes()
                      == d.tobytes(), "decode_png equals PIL's RGBA")
        sec["PIL decode"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    atlas = texture.pack_material_atlas(model.materials, model.images,
                                        size=1024)
    table = texture.expand_atlas_bilinear(atlas)
    sec["atlas (pack + expand)"] = time.perf_counter() - t0
    log(f"[assets] {len(maps)} PNG maps, {sum(map(len, blobs))} bytes; "
        f"PIL: {pil or 'does not import'} (texture.decode_image takes "
        f"{'PIL' if pil else 'utils/png.py'}"
        f"{', and decode_png equals it on every map' if pil else ''}); "
        f"helmet atlas table {table.nbytes} bytes; seconds: "
        + ", ".join(f"{k} {v:.2f}" for k, v in sec.items())
        + f" ({os.cpu_count()} host cores) {card}")
    return sec


def preset_phase(name, dev, card, results):
    """`name` from the asset tree at scenes.ASSETS through scenes.build
    at WIDTH x HEIGHT: PRESET_FRAMES frames with launch counts, CUDA-event
    frame ms; on full and helmet_lifted the kernel-path frame against the
    plain-path frame; on full and helmet (mostly sky) the stage table.
    Returns (build seconds, frame ms, the last frame's colour as sRGB
    u8, the BuiltScene)."""
    import torch
    from soc_real_time_renderer_tpu_torch import scenes
    from soc_real_time_renderer_tpu_torch.config import RenderConfig
    from soc_real_time_renderer_tpu_torch.graph import frame as fm
    from soc_real_time_renderer_tpu_torch.utils import image_io
    t0 = time.perf_counter()
    built = scenes.build(name, RenderConfig(width=WIDTH, height=HEIGHT),
                         device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    plan, batch = built.plan, built.batch
    path = path_of(plan, batch)
    noise = batch.cloud_noise
    log(f"[{name}] build {build_s:.1f} s: {batch.num_triangles} triangles, "
        f"{plan.atlas_num_materials} materials, atlas "
        f"{batch.atlas_packed.numel() * 4} bytes, cloud_noise "
        f"{None if noise is None else tuple(noise.shape)}, "
        f"shadow_statically_empty={plan.shadow_statically_empty}, crop "
        f"{plan.shadow_crop}; path {path}")
    check(noise is not None and tuple(noise.shape) == (64, 64)
          and "sky_lut" in path, "Clouds/noise.png feeds K6")
    check(("resolve_depth" in path) == (name == "helmet_lifted"),
          "K4 runs on helmet_lifted alone")
    out, (g, hist, mm, nm), counts = run_frames(built, plan, path,
                                                PRESET_FRAMES, dev)
    for k in counts:
        results[k][name] = {"launches": counts[k]}
    color = out.color
    cov = (out.gbuffer.depth < 1.0).float().mean().item()
    check(torch.isfinite(color).all().item() and int(out.overflow) == 0
          and 0.05 < cov and color.std().item() > 1e-3,
          f"finite, no overflow, coverage {cov:.4f}, not constant")
    srgb = image_io.to_srgb_u8(color)
    diff = None
    if name in ("full", "helmet_lifted"):
        outp, _ = fm.render_frame(plan, batch, g, hist, mm, nm,
                                  impl="plain")
        diff = (outp.color - color).abs().mean().item()
        check(diff < 1e-3, f"{name}: kernel-path frame vs plain-path frame")
        del outp
    ms = cuda_ms(lambda: fm.render_frame(plan, batch, g, hist, mm, nm),
                 TIMED)
    log(f"[{name}] launches over {PRESET_FRAMES} frames: {counts}; frame "
        f"{PRESET_FRAMES}: colour mean {color.mean().item():.4f} std "
        f"{color.std().item():.4f}, coverage {cov:.4f}, overflow 0"
        + ("" if diff is None else
           f", kernel vs plain colour mean abs {diff:.3g} (< 1e-3)")
        + f"; kernel-path frame {ms:.2f} ms (median of {TIMED}) {card}")
    if name in ("full", "helmet"):
        st = stage_table(built, g, hist, mm, nm)
        log(f"[{name}] stages (kernel path, ms, median of 3) {card}:")
        for s_, v in st.items():
            log(f"[{name}]   {s_}: {v:.2f}")
    del out
    torch.cuda.empty_cache()
    return build_s, ms, srgb, built


def cli_phase(tree, ref_srgb, card):
    """The render CLI as a user runs it, in a subprocess: --scene full at
    WIDTH x HEIGHT, PRESET_FRAMES frames, --dump-passes, SOC_ASSETS at
    the tree; its PNG against the preset phase's last in-process frame of
    `full` (mean abs < 0.5 levels); then --pair-cap 4096 for one frame
    prints the PAIRS warning and still exits 0.  Returns the first run's
    seconds."""
    from soc_real_time_renderer_tpu_torch.utils import png
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, SOC_ASSETS=tree, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    out = os.path.join(tree, "cli", "full.png")
    cmd = [sys.executable, "-m", "soc_real_time_renderer_tpu_torch.tools."
           "render", "--scene", "full", "--width", str(WIDTH), "--height",
           str(HEIGHT), "--frames", str(PRESET_FRAMES)]
    t0 = time.perf_counter()
    r = subprocess.run(cmd + ["--out", out, "--dump-passes"], env=env,
                       cwd=root, capture_output=True, text=True, timeout=600)
    sec = time.perf_counter() - t0
    for ln in r.stdout.splitlines():
        log(f"[cli] {ln}")
    check(r.returncode == 0, f"the CLI exits 0 (rc {r.returncode}): "
          f"{r.stderr[-2000:]}")
    with open(out, "rb") as f:
        img = png.decode_png(f.read())
    check(img.shape == (HEIGHT, WIDTH, 4) and (img[..., 3] == 255).all(),
          f"the CLI's PNG is ({HEIGHT}, {WIDTH}) RGB: {img.shape}")
    d = np.abs(img[..., :3].astype(np.int64) - ref_srgb.astype(np.int64))
    passes = [n for n in ("albedo", "emissive", "normal", "depth",
                          "velocity", "hdr")
              if os.path.exists(out[:-4] + f"_{n}.png")]
    log(f"[cli] {sec:.1f} s (process start, build, {PRESET_FRAMES} frames, "
        f"PNGs); its "
        f"PNG against the in-process frame: mean abs {d.mean():.4f} levels "
        f"(< 0.5), max {d.max()}; passes dumped {passes} {card}")
    check(d.mean() < 0.5, "the CLI's PNG matches the in-process frame")
    check(len(passes) == 6, "--dump-passes wrote every pass")
    r = subprocess.run(cmd[:-1] + ["1", "--pair-cap", "4096", "--out",
                                   os.path.join(tree, "cli", "capped.png")],
                       env=env, cwd=root, capture_output=True, text=True,
                       timeout=600)
    warned = [ln for ln in r.stdout.splitlines() if "PAIRS" in ln]
    log(f"[cli] --pair-cap 4096: rc {r.returncode}, {warned}")
    check(r.returncode == 0 and warned, "--pair-cap 4096 warns and exits 0")
    return sec


def viewer_phase(dev, card, results):
    """The interactive viewer as a user drives it: `full` from the asset
    tree at scenes.ASSETS at WIDTH x HEIGHT (4096^2 shadow map) behind
    ui/server.start_server with make_render_fn, and plain urllib
    requests: the first JPEG; VIEWER_INPUTS fly-camera inputs; an SSAO
    override; a second helmet (create, Transform, Mesh, position: the
    full rebuild tier, +15,480 triangles); the first helmet to y = 32
    (the cheap tier: the shadow proof fails, K4 launches from then on);
    the sun moved (the cheap tier re-proves); a resize to 1280x736 and
    back; a refused resize.  Each step waits, within stated seconds, for
    the frame index to advance.  The launch counts are set to 0 before
    the server starts and read after it stops; each frame's launches
    are taken in the render thread around the frame.  Then the medians
    of VIEWER_SAMPLES /metrics readings, each kernel against its plain
    version on the final state's inputs, and a GPUMetricPool table of a
    few passes.  Returns {"frame_ms", "latency_ms", "full_tier_s",
    "cheap_tier_s"}."""
    import io
    import threading
    import urllib.request
    import torch
    from PIL import Image
    from soc_real_time_renderer_tpu_torch import scenes
    from soc_real_time_renderer_tpu_torch.config import RenderConfig
    from soc_real_time_renderer_tpu_torch.graph import frame as fm
    from soc_real_time_renderer_tpu_torch.kernels import build as kb
    from soc_real_time_renderer_tpu_torch.ops import gbuffer, ssao, taa, \
        tonemap
    from soc_real_time_renderer_tpu_torch.ui import server as srv
    from soc_real_time_renderer_tpu_torch.utils import metrics
    name = "viewer"
    t0 = time.perf_counter()
    built = scenes.build("full", RenderConfig(width=WIDTH, height=HEIGHT),
                         device=dev)
    t_build = time.perf_counter() - t0
    T0 = built.batch.num_triangles
    check(built.plan.shadow_statically_empty, "full: shadow proved empty")

    # observation only: each frame's launches and each rebuild's tier and
    # seconds, taken where the render loop runs them
    per_frame = []             # (shadow elided, {kernel: launches})
    real_make = fm.make_render_fn
    # and the host seconds of the loop's three calls, (end time, seconds)
    host_s = {"frame_globals": [], "render_fn": [], "proof checks": [],
              "to_srgb_u8": []}

    def timed(part, fn, *a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        host_s[part].append((time.perf_counter(), time.perf_counter() - t))
        return out

    def counted(plan, impl=None):
        fn = real_make(plan, impl)

        def render(*a):
            before = dict(kb.launches)
            out = timed("render_fn", fn, *a)
            per_frame.append((plan.shadow_statically_empty,
                              {k: kb.launches[k] - before[k]
                               for k in before}))
            return out
        return render

    rebuilds = []              # (tier, seconds)
    real_rebuild = built.rebuild

    def timed_rebuild():
        b0 = built.batch
        t = time.perf_counter()
        real_rebuild()
        torch.cuda.synchronize()
        rebuilds.append(("full" if built.batch is not b0 else "cheap",
                         time.perf_counter() - t))

    built.rebuild = timed_rebuild
    real_globals, real_srgb = built.frame_globals, srv.to_srgb_u8
    real_checks = fm.check_sun_proof, fm.check_shadow_crop

    def timed_globals(*a, **kw):       # the loop's; /schema's peek is not
        return (real_globals(*a, **kw) if kw.get("peek")
                else timed("frame_globals", real_globals, *a, **kw))

    built.frame_globals = timed_globals
    srv.to_srgb_u8 = lambda color: timed("to_srgb_u8", real_srgb, color)
    # render_frame's two reads of the card (inside render_fn's seconds)
    fm.check_sun_proof = lambda plan, g: timed(
        "proof checks", real_checks[0], plan, g)
    fm.check_shadow_crop = lambda plan, mm: timed(
        "proof checks", real_checks[1], plan, mm)
    fm.make_render_fn = counted
    kb.reset_launches()
    before = set(threading.enumerate())
    server, state, panel = srv.start_server(
        built, fm.make_render_fn(built.plan),
        fm.RenderHistory.create(built.plan.config, device=dev), port=0,
        host="127.0.0.1")
    loop = [t for t in threading.enumerate() if t not in before]
    check(len(loop) == 1, "start_server started one render thread")
    loop = loop[0]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    marks = []                 # (step, frames recorded when it ended)
    step_s = {}

    def get(path):
        with urllib.request.urlopen(base + path, timeout=60) as r:
            return r.read()

    def post(path, body):
        req = urllib.request.Request(base + path,
                                     data=json.dumps(body).encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.read()

    def until(cond, seconds, what):
        t = time.perf_counter()
        while not cond():
            check(loop.is_alive(), f"{what}: the render thread is alive")
            check(time.perf_counter() - t < seconds,
                  f"{what} within {seconds} s")
            time.sleep(0.005)

    def settled():
        return not (state.needs_rebuild or state.pending_resize
                    or state.terrain_dirty)

    def step(label, seconds, n=3):
        """The edit applied and the frame index n frames further, within
        `seconds` of the step's start."""
        until(settled, seconds, f"{label}: the edit applied")
        f0 = state.frame_index
        until(lambda: state.frame_index >= f0 + n, seconds,
              f"{label}: frame_index past {f0 + n}")
        marks.append((label, len(per_frame)))
        step_s[label] = time.perf_counter() - t_step

    def jpeg_size():
        jpg = get("/frame.jpg")
        return (Image.open(io.BytesIO(jpg)).size
                if jpg.startswith(b"\xff\xd8") else None)

    def eid_of(tag):
        nodes = json.loads(get("/schema"))["scene"]["nodes"]
        return next(int(i) for i, n in nodes.items() if n["tag"] == tag)

    samples = []
    try:
        # 1. the first JPEG
        t_step = time.perf_counter()
        until(lambda: jpeg_size() == (WIDTH, HEIGHT), 60.0,
              "the first JPEG at full size")
        step("1 first JPEG", 60.0)
        # 2. fly camera
        t_step = time.perf_counter()
        p0 = built.camera_position.copy()
        for i in range(VIEWER_INPUTS):
            post("/input", {"forward": True, "dx": 4.0, "dy": 1.0})
        moved = float(np.linalg.norm(built._fly.position - p0))
        check(moved > 1.0 and not built.animate,
              f"{VIEWER_INPUTS} inputs moved the fly camera {moved:.3f}")
        step("2 fly camera", 30.0)
        # 3. an SSAO override
        t_step = time.perf_counter()
        post("/set", {"section": "ssao settings", "name": "bias",
                      "value": 0.125})
        bias = [p["value"] for p in json.loads(get("/schema"))["settings"]
                ["ssao settings"] if p["name"] == "bias"][0]
        check(abs(bias - 0.125) < 1e-6, f"/schema shows ssao bias {bias}")
        step("3 ssao bias", 30.0)
        # 4. a second helmet: the full tier
        t_step = time.perf_counter()
        n_rb = len(rebuilds)
        post("/scene", {"op": "create", "name": "viewer helmet"})
        eid = eid_of("viewer helmet")
        for op in ({"op": "add_component", "id": eid,
                    "type": "TransformComponent"},
                   {"op": "add_component", "id": eid,
                    "type": "MeshComponent"},
                   {"op": "set_property", "id": eid,
                    "component": "TransformComponent", "prop": "position",
                    "value": [1.2, 0.0, 0.0]}):
            check(post("/scene", op) == b"{}", f"/scene {op}")
        until(lambda: state.built.batch.num_triangles > T0, 120.0,
              "the batch re-packed")
        step("4 second helmet (full tier)", 120.0)
        full_s = [s for tier, s in rebuilds[n_rb:] if tier == "full"]
        check(len(full_s) == 1 and built.batch.num_triangles == T0 + 15_480,
              f"one full-tier rebuild added 15,480 triangles: {T0} -> "
              f"{built.batch.num_triangles}, {rebuilds[n_rb:]}")
        # 5. the first helmet into the sun volume: the cheap tier
        t_step = time.perf_counter()
        n_rb = len(rebuilds)
        batch = built.batch
        check(post("/scene", {"op": "set_property",
                              "id": eid_of("damaged helmet model"),
                              "component": "TransformComponent",
                              "prop": "position",
                              "value": [0.0, 32.0, 0.0]}) == b"{}",
              "the helmet moved")
        until(lambda: not state.built.plan.shadow_statically_empty, 60.0,
              "the shadow proof fails")
        step("5 helmet to y = 32 (cheap tier)", 60.0)
        cheap_s = [s for tier, s in rebuilds[n_rb:] if tier == "cheap"]
        check(cheap_s and built.batch is batch
              and all(t == "cheap" for t, _ in rebuilds[n_rb:]),
              f"the cheap tier alone: {rebuilds[n_rb:]}")
        k5 = marks[-2][1]              # frames before step 5
        # 6. the sun moved: the cheap tier re-proves
        t_step = time.perf_counter()
        n_rb, f6 = len(rebuilds), state.frame_index
        post("/set", {"section": "sun settings", "name": "position",
                      "value": [-3.2, 44.0, -4.0]})
        step("6 sun moved", 60.0, n=5)
        check(len(rebuilds) > n_rb and rebuilds[-1][0] == "cheap"
              and state.frame_index >= f6 + 5,
              "the cheap tier re-proved and frames went on")
        sun = [p["value"] for p in json.loads(get("/schema"))["settings"]
               ["sun settings"] if p["name"] == "position"][0]
        check(np.allclose(sun, [-3.2, 44.0, -4.0]), f"the sun at {sun}")
        # 7. resize and back
        t_step = time.perf_counter()
        for w, h in ((1280, 736), (WIDTH, HEIGHT)):
            post("/resize", {"width": w, "height": h})
            until(lambda: jpeg_size() == (w, h), 60.0, f"a {w}x{h} JPEG")
        step("7 resize 1280x736 and back", 60.0)
        # 8. a refused resize
        t_step = time.perf_counter()
        check(b"error" in post("/resize", {"width": 100, "height": 64})
              and state.pending_resize is None, "100x64 is refused")
        step("8 resize 100x64 refused", 30.0)
        # /metrics at WIDTH x HEIGHT, one reading per presented frame
        t = t_window = time.perf_counter()
        while len(samples) < VIEWER_SAMPLES:
            check(loop.is_alive() and time.perf_counter() - t < 60.0,
                  f"{VIEWER_SAMPLES} /metrics readings within 60 s")
            m = json.loads(get("/metrics"))
            if not samples or m["frame"] != samples[-1]["frame"]:
                samples.append(m)
            time.sleep(0.005)
    finally:
        state.stop = True
        server.shutdown()
        server.server_close()
        loop.join(timeout=120)
        fm.make_render_fn = real_make
        srv.to_srgb_u8 = real_srgb
        fm.check_sun_proof, fm.check_shadow_crop = real_checks
        del built.frame_globals
    check(not loop.is_alive(), "the render thread stopped")
    torch.cuda.synchronize()
    counts = dict(kb.launches)
    for k in counts:
        results[k][name] = {"launches": counts[k]}

    # launches: every frame runs K1, K5, K2, K6, K3f (the noise texture:
    # never K6p); K4 where the plan does not elide the shadow, i.e. from
    # step 5 on
    n = len(per_frame)
    summed = {k: sum(d[k] for _, d in per_frame) for k in counts}
    check(summed == counts, f"every launch came from a frame: {summed} "
          f"vs {counts}")
    check(all(d == {k: 0 if k == "sky_lut_procedural" or k in STANDALONE
                    or k in LIT + SSR or (k == "resolve_depth" and elided)
                    else 1
                    for k in counts} for elided, d in per_frame),
          "each frame launched its path's kernels once")
    k4_before = sum(d["resolve_depth"] for _, d in per_frame[:k5])
    k4_after = sum(d["resolve_depth"] for _, d in per_frame[k5:])
    check(k4_before == 0 and k4_after > 0,
          f"K4: {k4_before} launches before step 5, {k4_after} after")
    prev = 0
    for label, end in marks:
        sums = {k: sum(d[k] for _, d in per_frame[prev:end])
                for k in counts}
        log(f"[{name}] step {label}: {end - prev} frames, "
            f"{step_s[label]:.2f} s, launches {sums}")
        prev = end
    fms = [s["frame_ms"] for s in samples]
    lat = [s["latency_ms"] for s in samples]
    check(all(s["overflow"] == 0 and s["tex_dirty"] == -1
              for s in samples), "overflow 0, tex_dirty -1")
    out = {"frame_ms": statistics.median(fms),
           "latency_ms": statistics.median(lat),
           "full_tier_s": full_s[0], "cheap_tier_s": min(cheap_s)}
    log(f"[{name}] full {WIDTH}x{HEIGHT}, build {t_build:.1f} s, {n} frames "
        f"in the loop, launches {counts}; rebuilds {rebuilds}; full tier "
        f"{out['full_tier_s']:.2f} s (+15,480 triangles), cheap tier "
        f"{out['cheap_tier_s']:.3f} s; /metrics over {len(samples)} "
        f"frames at {WIDTH}x{HEIGHT}: frame_ms median {out['frame_ms']} "
        f"(min {min(fms)}, max {max(fms)}), latency_ms median "
        f"{out['latency_ms']} (min {min(lat)}, max {max(lat)}) {card}")
    # where a loop iteration's host time went over the same window (the
    # two proof checks of a frame summed, within render_fn); the rest of
    # frame_ms is the JPEG encode and the loop's own Python
    win = {k: [s for te, s in v if te >= t_window]
           for k, v in host_s.items()}
    win["proof checks"] = [a + b for a, b in zip(win["proof checks"][::2],
                                                 win["proof checks"][1::2])]
    parts = {k: statistics.median(v) * 1e3 for k, v in win.items()}
    rest = out["frame_ms"] - sum(v for k, v in parts.items()
                                 if k != "proof checks")
    log(f"[{name}] the render loop's host ms over the /metrics window "
        f"(medians): " + ", ".join(f"{k} {v:.2f}" for k, v in parts.items())
        + f"; frame_ms less the other three {rest:.2f} {card}")

    # each kernel against its plain version on the final state's inputs
    built = state.built
    plan = built.plan
    check(not plan.shadow_statically_empty and plan.config.width == WIDTH,
          "the final state rasters the shadow at full size")
    path_k, cases = kernel_cases(name, built, dev, min_lit=0.0)
    check(sorted(path_k) == NOISE_PATH, f"all six on the path: {path_k}")
    for k, (call, cmp, _, _, _) in cases.items():
        got, want = call("cuda"), call("plain")
        torch.cuda.synchronize()
        err, msg, ok = cmp(got, want)
        log(f"[{name}] parity {k}: {msg}")
        check(ok, f"{name} {k} parity")

    # a few passes timed by utils/metrics (CUDA events, 8 calls each)
    g, mm, nm = built.frame_globals(state.frame_index, peek=True)
    hist = fm.RenderHistory.create(plan.config, device=dev)
    batch = built.batch
    vis, recs, smap, ovf = fm.raster_stage(plan, batch, g, mm, nm)
    gbuf = gbuffer.resolve_gbuffer(
        vis, recs, batch.atlas_packed, g.camera_prev.projection_view,
        atlas_size=plan.atlas_size, layer_stride=plan.atlas_layer_stride,
        n_levels=plan.atlas_n_levels, filter_mode=plan.texture_filter)
    out0, _ = fm.render_frame(plan, batch, g, hist, mm, nm)
    pool = metrics.GPUMetricPool()
    for pass_name, fn in (
            ("whole frame", lambda: fm.render_frame(plan, batch, g, hist, mm,
                                                    nm)),
            ("depth prepass + shadow (raster_stage: K1, K4)",
             lambda: fm.raster_stage(plan, batch, g, mm, nm)),
            ("g-buffer (K5)", lambda: gbuffer.resolve_gbuffer(
                vis, recs, batch.atlas_packed, g.camera_prev.projection_view,
                atlas_size=plan.atlas_size,
                layer_stride=plan.atlas_layer_stride,
                n_levels=plan.atlas_n_levels,
                filter_mode=plan.texture_filter)),
            ("ssao (K2)", lambda: ssao.ssao_generate(
                vis.depth, gbuf.normal, g, plan.config.ssao_kernel_size)),
            ("taa (K3f)", lambda: taa.taa(
                out0.hdr, vis.depth, gbuf.velocity, hist.previous_color,
                hist.previous_velocity, g.frame_counter)),
            ("tonemap", lambda: tonemap.tone_map(out0.hdr, hist.exposure,
                                                 g))):
        pool.get(pass_name).measure(fn, device=dev)
    log(f"[{name}] GPUMetricPool (utils/metrics.py, ms a call, 8 calls "
        f"between CUDA events) {card}: {pool.table()}; by category "
        f"{ {c: round(v, 3) for c, v in pool.category_totals().items()} }")
    # the loop's three pieces alone, one thread (median of 3): a frame's
    # dispatch and its end, then the readback and encode
    enc = {"render_frame dispatch": [], "render_frame to its end": [],
           "to_srgb_u8": [], "JPEG": []}
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fm.render_frame(plan, batch, g, hist, mm, nm)
        enc["render_frame dispatch"].append(time.perf_counter() - t)
        torch.cuda.synchronize()
        enc["render_frame to its end"].append(time.perf_counter() - t)
        t = time.perf_counter()
        srgb = srv.to_srgb_u8(out0.color)
        t1 = time.perf_counter()
        Image.fromarray(srgb).save(io.BytesIO(), format="JPEG", quality=85)
        enc["to_srgb_u8"].append(t1 - t)
        enc["JPEG"].append(time.perf_counter() - t1)
    log(f"[{name}] one {WIDTH}x{HEIGHT} frame alone, the loop stopped: "
        + ", ".join(f"{k} {statistics.median(v) * 1e3:.2f} ms"
                    for k, v in enc.items()) + f" {card}")
    del built, state, vis, recs, gbuf, out0, hist
    torch.cuda.empty_cache()
    return out


def texparts_phase(built, card, tmp):
    """The texture-tap attribution path on `full` (the preset phase's
    build at WIDTH x HEIGHT from the synthetic tree), through the port's
    tools in this process: capture_texfields (frame 1's tap fields, what
    resolve_gbuffer hands K5), bench_texsample, bench_texkernel_parts and
    bench_texmm2 on them, each with the launch counts set to 0 just
    before and read just after (the two variant benches launch only
    their variants, each of their runs at least once; nothing counts as
    K5).  Then, outside those counts, every full variant against its
    plain version on the capture in all three filter modes, bit for bit
    (planar against sample_packed_atlas, interleaved against its
    transpose with lane 11 zero, bf16 against that cast); each variant's
    card ms beside the full kernel's and its bound from its own bytes
    (texsample.variant_bytes, the distinct rows from tap_rows), its
    registers and SASS LDG / STG counts (each must keep some: a variant
    the compiler emptied would time nothing).  Returns the JSON rows of
    VARIANT_KERNELS."""
    import torch
    from soc_real_time_renderer_tpu_torch.kernels import build as kb
    from soc_real_time_renderer_tpu_torch.ops import texsample
    from soc_real_time_renderer_tpu_torch.tools import \
        bench_texkernel_parts, bench_texmm2, bench_texsample, \
        capture_texfields
    tools = {"bench_texkernel_parts": bench_texkernel_parts,
             "bench_texmm2": bench_texmm2}
    path = os.path.join(tmp, "texfields.npz")
    size = ["--scene", "full", "--width", str(WIDTH), "--height",
            str(HEIGHT)]
    fields_arg = ["--fields", path]

    kb.reset_launches()
    fields = capture_texfields.main(size + ["--out", path], built=built)
    check(kb.launches["texsample"] == 1 and not kb.variant_launches,
          f"the capture took one K5 tap: {kb.launches}")
    (atlas, mid, uv, lod), kw = fields["args"]
    P = mid.numel()
    live = float(fields["live"].mean())
    check(P == WIDTH * HEIGHT and 0.0 < live <= 1.0
          and np.isfinite(fields["lod"]).all(),
          f"the capture: {P} pixels, live {live}, finite lod")

    kb.reset_launches()
    tex_rows = bench_texsample.main(size + fields_arg, built=built)
    check(kb.launches["texsample"] > 0 and not kb.variant_launches
          and all(r["device_ms"] for r in tex_rows
                  if r["label"].startswith("K5")),
          f"bench_texsample: K5 in each mode, no variant: {kb.launches}")
    runs = {}
    for name, (_, _, tool) in VARIANT_KERNELS.items():
        kb.reset_launches()
        rows = tools[tool].main(size + fields_arg, built=built)
        counts = dict(kb.variant_launches)
        check(set(counts) == {r["variant"] for r in rows}
              and not any(kb.launches.values()),
              f"{tool}: each run's variant launched, nothing counted as a "
              f"frame's kernel: {counts}, {kb.launches}")
        for r in rows:
            check(r["registers"] and r["LDG"] > 0 and r["STG"] > 0,
                  f"{tool} {r['label']}: registers, loads and stores kept "
                  f"({r['registers']}, LDG {r['LDG']}, STG {r['STG']})")
            if r["max_abs_err"] is not None:
                check(r["max_abs_err"] == 0.0,
                      f"{tool} {r['label']}: max abs {r['max_abs_err']}")
        runs[name] = (rows, counts)

    errs = {}
    base = {k: v for k, v in kw.items() if k != "filter_mode"}
    for mode in ("nearest", "bilinear", "trilinear"):
        planar = texsample.sample_atlas(atlas, mid, uv, lod, impl="plain",
                                        filter_mode=mode, **base)
        inter = torch.cat([planar.T, torch.zeros_like(planar[:1].T)], 1)
        want = {"planar": planar, "interleaved": inter,
                "interleaved_bf16": inter.to(torch.bfloat16)}
        for name, v in texsample.VARIANTS.items():
            if not v.full:
                continue
            got = texsample.sample_atlas_variant(
                atlas, mid, uv, lod, variant=name, filter_mode=mode, **base)
            torch.cuda.synchronize()
            w = want[v.store]
            errs[name, mode] = (got.float() - w.float()).abs().max().item()
            check(got.dtype == w.dtype and torch.equal(got, w),
                  f"{name} {mode}: bit-identical to its plain version "
                  f"(max abs {errs[name, mode]})")
            del got
        del planar, inter, want
    log(f"[texparts] full variants against their plain versions on "
        f"{P} pixels of full, nearest / bilinear / trilinear: "
        + ", ".join(f"{n} " + " / ".join(f"{errs[n, m]:.3g}" for m in (
            "nearest", "bilinear", "trilinear"))
            for n in sorted({n for n, _ in errs})) + " (== 0)")

    bil = {**kw, "filter_mode": "bilinear"}
    n_rows = tap_rows(mid, uv, lod, bil)
    plain_ms = cuda_ms(lambda: texsample.sample_atlas(
        atlas, mid, uv, lod, impl="plain", **bil), TIMED)

    def bound_of(variant):
        v = texsample.VARIANTS[variant]
        ops = (0 if {"unpack", "tap"} & set(v.skip)
               else P * 11 * TEX_OPS_CHANNEL)
        return bound(texsample.variant_bytes(variant, P, n_rows,
                                             atlas.shape[0]), ops)

    out = []
    for name, (src, replaces, tool) in VARIANT_KERNELS.items():
        rows, counts = runs[name]
        full = rows[1]           # the run after the warm-up: production
        check(full["variant"] == "planar", f"{tool}'s second run is K5")
        variants = {}
        for r in rows:
            b_ms, b_by = bound_of(r["variant"])
            variants[r["label"]] = {
                "variant": r["variant"], "device_ms": r["device_ms"],
                "ms": r["ms"], "bound_ms": b_ms, "bound_by": b_by,
                "registers": r["registers"], "LDG": r["LDG"],
                "STG": r["STG"]}
            ratio = r["device_ms"] / full["device_ms"]
            log(f"[texparts] {tool} {r['label']:30s} {r['variant']:17s} "
                f"card {r['device_ms']:.4f} ms ({ratio:.2f}x full), "
                f"bound {b_ms:.4f} ms by "
                f"{b_by} ({b_ms / r['device_ms']:.0%} of it), per call "
                f"{r['ms']:.4f} ms, regs {r['registers']} LDG {r['LDG']} "
                f"STG {r['STG']} {card}")
        b_ms, b_by = bound_of("planar")
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "scene": "full",
            "launches": sum(counts.values()), "band_launches": 0,
            "max_abs_err": max(errs.values()), "ms": full["ms"],
            "device_ms": full["device_ms"], "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library_device_ms": None, "launch_device_ms": None,
            "variant_launches": counts, "variants": variants})
    log(f"[texparts] full {WIDTH}x{HEIGHT} frame 1: {P} pixels, live "
        f"{live:.4f}, "
        f"{n_rows} distinct atlas rows (bilinear), plain gather {plain_ms:.4f}"
        f" ms per call; bench_texsample: " + ", ".join(
            f"{r['label']} {r['device_ms'] or r['ms']}" for r in tex_rows
            if r["ms"] is not None) + f" {card}")
    return out


def bench_phase(card):
    """The three measuring tools' mains in this process, on the
    synthetic tree scenes.ASSETS points at: bench on sponza, the
    BASELINE table, the toggle attribution of config 5; each run's
    launches (the tools check them too) and paths."""
    from soc_real_time_renderer_tpu_torch.kernels import build as kb
    from soc_real_time_renderer_tpu_torch.tools import bench, \
        bench_baselines, bench_toggle
    # the synthetic tree's noise: K6, not K6p; config 7's SSR: K8
    every = set(NOISE_PATH + SSR)
    line = bench.main([], {"BENCH_SCENE": "sponza", "BENCH_WIDTH": "1280",
                           "BENCH_HEIGHT": "736",
                           "BENCH_FRAMES": str(BENCH_FRAMES)})
    ran = {k for k, n in kb.launches.items() if n}
    check(line["assets"] == "synthetic" and "sponza 1280x736" in
          line["metric"] and card.strip("[]") == line["device"]
          and ran == {"resolve", "texsample", "ssao_taps", "sky_lut",
                      "taa_resolve"}
          and all(kb.launches[k] == BENCH_FRAMES for k in ran),
          f"bench: sponza, synthetic assets, the card's name, K1, K5, K2, "
          f"K6, K3f {BENCH_FRAMES} times each: {line}, {kb.launches}")
    rows = bench_baselines.main(["--frames", str(TABLE_FRAMES)])
    check([r["config"] for r in rows] == list(range(1, 8))
          and all(r["launches"][k] == (TABLE_FRAMES if k in r["path"]
                                       else 0)
                  for r in rows for k in KERNELS)
          and set().union(*(r["path"] for r in rows)) == every
          and not any(o for r in rows for o in r["overflow"])
          and not any(r["syncs"] for r in rows),
          "bench_baselines: seven rows, each kernel of a row's path once "
          "a frame and no other, all seven kernels over the table, no "
          "overflow, no call in a timed loop waited for the card")
    toggles = bench_toggle.main(["--config", str(TOGGLE_CONFIG),
                                 "--frames", str(TABLE_FRAMES)])
    gone = {"ssao": "ssao_taps", "taa": "taa_resolve",
            "clouds": "sky_lut", "tex_none": "texsample"}
    check(sorted(toggles) == sorted(bench_toggle.KEPT)
          and all(len(r["delta_ms"]) == bench_toggle.ROUNDS
                  for r in toggles.values())
          and all(k not in toggles[t]["path"] for t, k in gone.items()),
          f"bench_toggle: every kept toggle, {bench_toggle.ROUNDS} rounds "
          f"each, its kernel gone where it removes one")
    return line, rows, toggles


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this smoke run needs a GPU")
    # the renderer, before any output: without it nothing is printed
    import soc_real_time_renderer_tpu_torch  # noqa: F401
    from soc_real_time_renderer_tpu_torch.kernels import build as kb

    t_start = time.perf_counter()
    name_limit = smi("name,power.limit")
    card = f"[{name_limit}]"
    log(f"phase 1 device: {name_limit}")
    log(f"phase 1 torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")

    # phase 2: build the kernels from the checkout's sources
    t0 = time.perf_counter()
    kb.library()
    log(f"phase 2 build: {time.perf_counter() - t0:.1f} s (nvcc "
        f"{kb.build_seconds if kb.build_seconds is not None else 0:.1f} s, "
        f"one process per source) -> {kb.LIB}")
    for ln in kb.build_log.splitlines():
        if "registers" in ln or "Compiling entry" in ln:
            log(f"  ptxas: {ln.strip()}")

    # phases 3-7, scene by scene
    results = {}
    frames = {}
    seconds = {}
    for name in ("terrain", "full_nohelmet", "atrium_lifted",
                 "full_lit_nohelmet"):
        t0 = time.perf_counter()
        frames[name] = scene_phase(name, dev, card, results)
        seconds[name] = time.perf_counter() - t0
    check(sorted(results) == sorted(k for k in KERNELS if k not in SSR),
          f"every kernel but K8 ran on some scene: {sorted(results)}")
    # the passes that are off by default
    pass_ms = {}
    for name, phase in (("atrium_passes", passes_phase),
                        ("terrain_perpixel", perpixel_phase)):
        t0 = time.perf_counter()
        pass_ms[name] = phase(dev, card, results)
        seconds[name] = time.perf_counter() - t0
    # B views in one step
    batch_ms = {}
    for name in ("atrium_lifted", "terrain", "atrium_passes",
                 "terrain_perpixel"):
        t0 = time.perf_counter()
        batch_ms[name] = batched_phase(name, dev, card, results)
        seconds[f"batched {name}"] = time.perf_counter() - t0
    # one frame in row bands over a mesh that names the card four times
    t0 = time.perf_counter()
    shard = sharded_phase(dev, card, results)
    seconds["sharded"] = time.perf_counter() - t0
    # the asset path: a written asset tree, the four glTF presets, the CLI
    from soc_real_time_renderer_tpu_torch import scenes
    preset_ms = {}
    with tempfile.TemporaryDirectory() as tree:
        t0 = time.perf_counter()
        asset_phase(tree, card)
        seconds["assets"] = time.perf_counter() - t0
        scenes.ASSETS = tree
        for name in PRESETS:
            t0 = time.perf_counter()
            _, preset_ms[name], srgb, built = preset_phase(name, dev, card,
                                                           results)
            seconds[name] = time.perf_counter() - t0
        # the texture-tap attribution path on full's build (PRESETS' last)
        t0 = time.perf_counter()
        tex_kernels = texparts_phase(built, card, tree)
        seconds["texparts"] = time.perf_counter() - t0
        del built
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cli_phase(tree, srgb, card)
        seconds["cli"] = time.perf_counter() - t0
        # the interactive viewer on `full`
        t0 = time.perf_counter()
        viewer = viewer_phase(dev, card, results)
        seconds["viewer"] = time.perf_counter() - t0
        # the measuring tools
        t0 = time.perf_counter()
        bench_line, _, _ = bench_phase(card)
        seconds["bench"] = time.perf_counter() - t0
    log(f"summary {card}: " + ", ".join(
        f"{n} kernel path {k:.2f} ms vs plain {p:.2f} ms"
        for n, (k, p) in frames.items()) + "; " + ", ".join(
        f"{n} {v:.2f} ms" for n, v in {**pass_ms, **preset_ms}.items())
        + "; " + ", ".join(
            f"batched {n} {b:.2f} ms vs {len(BATCH_POSITIONS[n])} singles "
            f"{s:.2f} ms, peak {m1:.0f} / {mb:.0f} MiB"
            for n, (b, s, m1, mb) in batch_ms.items())
        + f"; sharded atrium_lifted {SHARD_BANDS} bands {shard[0]:.2f} ms "
        f"vs unsplit {shard[1]:.2f} ms, peak {shard[2]:.0f} / "
        f"{shard[3]:.0f} MiB"
        + f"; viewer frame_ms {viewer['frame_ms']} latency_ms "
        f"{viewer['latency_ms']} (medians), full tier "
        f"{viewer['full_tier_s']:.2f} s, cheap tier "
        f"{viewer['cheap_tier_s']:.3f} s"
        + f"; bench sponza 1280x736 {bench_line['value']} ms/frame "
        f"(median {bench_line['median_ms']:.2f})"
        + "; seconds per phase " + ", ".join(
        f"{n} {v:.1f}" for n, v in seconds.items())
        + f"; total {time.perf_counter() - t_start:.0f} s")

    kernels = []
    for name, (src, replaces) in KERNELS.items():
        home = results[name][HOME[name]]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "scene": HOME[name],
            "launches": sum(r["launches"] for r in results[name].values()),
            "band_launches": shard[4][name],
            **{k: home[k] for k in ("max_abs_err", "ms", "device_ms",
                                    "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "library_device_ms",
                                    "launch_device_ms")},
            "by_scene": results[name]})
    kernels.extend(tex_kernels)
    check(len(kernels) == 12, "the JSON lists all eight TPU kernels' "
          "counterparts, K6p, K3f, K7 and K8")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except Exception:
        traceback.print_exc()
        sys.exit(1)
