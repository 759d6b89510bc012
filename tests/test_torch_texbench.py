"""The port's texture-tap attribution tools on the CPU, at a tiny size:
``tools/capture_texfields.py``, ``bench_texsample.py``,
``bench_texkernel_parts.py`` and ``bench_texmm2.py`` (their kernels run
only on the card: tests/test_torch_cuda.py and chip_smoke.py's
``texparts`` phase hold them there).

The capture is held against the JAX ``tools/capture_texfields.py``, run
in process on the same reduced ``full_nohelmet`` (tests/torch_scene_kit,
128x64, 64^2 atlas; the JAX file is not edited: its ``scenes.build`` is
swapped for the kit's scene); the two benches' run lists against the JAX
tools' (read with ast); the plain statements of the interleaved and bf16
layouts against the production plain tap rearranged; the variant table
of ``texsample.cu`` (which cannot compile here) against
``ops/texsample.VARIANTS``.
"""
import ast
import dataclasses
import importlib.util
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import test_torch_parallel as tp
import torch_scene_kit as kit
from soc_real_time_renderer_tpu import config as jcfg
from soc_real_time_renderer_tpu import scenes as jscenes
from soc_real_time_renderer_tpu.graph import frame as jframe
from soc_real_time_renderer_tpu_torch import scenes as pscenes
from soc_real_time_renderer_tpu_torch.config import RenderConfig
from soc_real_time_renderer_tpu_torch.graph import frame as pframe
from soc_real_time_renderer_tpu_torch.kernels import build as kb
from soc_real_time_renderer_tpu_torch.models.texture import \
    PackedMaterialAtlas, expand_atlas_bilinear
from soc_real_time_renderer_tpu_torch.ops import clouds as pclouds
from soc_real_time_renderer_tpu_torch.ops import gbuffer as pgbuf
from soc_real_time_renderer_tpu_torch.ops import sky as psky
from soc_real_time_renderer_tpu_torch.ops import texsample as ptex
from soc_real_time_renderer_tpu_torch.tools import bench_texkernel_parts
from soc_real_time_renderer_tpu_torch.tools import bench_texmm2
from soc_real_time_renderer_tpu_torch.tools import bench_texsample
from soc_real_time_renderer_tpu_torch.tools import capture_texfields

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = ["--scene", "full", "--width", "128", "--height", "64"]
CFG = dict(width=128, height=64, shadow_resolution=512)
# JAX tool vs port capture, on pixels whose tri ids agree: the JAX tool
# sums the bf16 hi/lo split of the records (capture_texfields.py:55: ~16
# mantissa bits a record), the port reads f32 records, and XLA's CPU jit
# contracts FMA (ROADMAP C7), which moves lod most (its log2 of squared
# derivatives).  Read at 128x64: max abs u 2.1e-4, v 2.8e-3, lod 1.2e-2;
# mean abs u 9.4e-6, v 1.7e-5, lod 8.8e-5.  Bounds about 4x the reading.
MAX_ABS = {"u": 1e-3, "v": 1e-2, "lod": 5e-2}
MEAN_ABS = {"u": 5e-5, "v": 1e-4, "lod": 5e-4}


def _jax_tool(name):
    """The JAX repo-level tool tools/<name>.py as a module (it imports
    jax inside main)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    """(jax npz, port npz, the JAX frame's tri ids, the port's BuiltScene
    and its capture): both tools' mains on the same reduced scene,
    frame 1."""
    tmp = tmp_path_factory.mktemp("texfields")
    jb, pb = kit.build_pair("full_nohelmet", jcfg.RenderConfig(**CFG),
                            RenderConfig(**CFG))
    tri = []
    real = jframe.raster_stage

    def spy(*a, **k):       # the tri ids of the frame the JAX tool rasters
        out = real(*a, **k)
        jax.debug.callback(lambda t: tri.append(np.asarray(t)),
                           out[0].tri_id)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jscenes, "build", lambda *a, **k: jb)
        mp.setattr(jframe, "raster_stage", spy)
        mp.setattr(sys, "argv", ["capture_texfields.py", "--width", "128",
                                 "--height", "64", "--out",
                                 str(tmp / "jax.npz")])
        _jax_tool("capture_texfields").main()
        mp.setattr(pscenes, "build", lambda *a, **k: pb)
        fields = capture_texfields.main(
            [*SIZE, "--out", str(tmp / "port.npz"), "--device", "cpu"])
    return (np.load(tmp / "jax.npz"), np.load(tmp / "port.npz"), tri[0],
            pb, fields, tmp / "port.npz")


def test_capture_matches_the_jax_tool(captures, capsys):
    """Same keys, shapes and types; mid and live equal on every pixel
    where both packages' tri ids agree; u, v, lod within MAX_ABS and
    MEAN_ABS on the live ones; the same summary line."""
    j, p, jtri, pb, _, _ = captures
    assert sorted(j.files) == sorted(p.files) == sorted(
        capture_texfields.FIELDS)
    for k in j.files:
        assert j[k].shape == p[k].shape == (64, 128), k
        assert j[k].dtype == p[k].dtype, k
    g, mm, nm = pb.frame_globals(1, peek=True)
    ptri = pframe.raster_stage(pb.plan, pb.batch, g, mm, nm)[0].tri_id
    agree = jtri.reshape(64, 128) == ptri.numpy()
    assert agree.mean() > 0.999
    assert (j["mid"] == p["mid"])[agree].all()
    assert (j["live"] == p["live"])[agree].all()
    live = agree & p["live"]
    assert live.mean() > 0.5
    for k in MAX_ABS:
        d = np.abs(j[k] - p[k])[live]
        assert d.max() <= MAX_ABS[k] and d.mean() <= MEAN_ABS[k], \
            (k, d.max(), d.mean())
    assert np.isfinite(p["lod"]).all()
    assert capture_texfields.summary(p) == capture_texfields.summary(j)


def test_capture_is_what_the_frame_taps(captures, monkeypatch):
    """The capture equals, bit for bit, the (mid, uv, lod) that
    resolve_gbuffer passes sample_atlas in render_frame of the same
    frame (the sky LUT seeded: K6's plain version takes seconds here)."""
    _, p, _, pb, fields, _ = captures
    lut = torch.from_numpy(tp.luts_seeded(n=4))
    monkeypatch.setattr(psky, "render_sky_lut_noise",
                        lambda g_, *a, **k: lut[g_.frame_counter.long()])
    monkeypatch.setattr(pclouds, "render_sky_lut",
                        lambda g_, *a, **k: lut[g_.frame_counter.long()])
    seen = []
    real = ptex.sample_atlas

    def spy(*a, **k):
        seen.append(a)
        return real(*a, **k)

    monkeypatch.setattr(ptex, "sample_atlas", spy)
    g, mm, nm = pb.frame_globals(1, peek=True)
    pframe.render_frame(pb.plan, pb.batch, g,
                        pframe.RenderHistory.create(pb.plan.config,
                                                    device="cpu"), mm, nm)
    assert len(seen) == 1
    _, mid, uv, lod = seen[0]
    (_, cmid, cuv, clod), kw = fields["args"]
    assert torch.equal(mid, cmid) and torch.equal(uv, cuv) \
        and torch.equal(lod, clod)
    assert kw["filter_mode"] == pb.plan.texture_filter
    np.testing.assert_array_equal(p["mid"].reshape(-1), mid.numpy())
    np.testing.assert_array_equal(p["u"].reshape(-1), uv[0].numpy())
    np.testing.assert_array_equal(p["v"].reshape(-1), uv[1].numpy())
    np.testing.assert_array_equal(p["lod"].reshape(-1), lod.numpy())


def test_bench_texsample_plain_rows_on_the_cpu(captures, capsys):
    """--device cpu: the plain gather and the G-buffer stage timed on
    the host clock, the K5 rows marked as needing the card, the JAX rows
    without a counterpart named."""
    *_, pb, _, path = captures
    rows = bench_texsample.main([*SIZE, "--fields", str(path), "--reps",
                                 "2", "--device", "cpu"], built=pb)
    by = {r["label"]: r for r in rows}
    assert list(by) == ["phase1 planning", "full sample_atlas_tiled",
                        "K5 nearest", "K5 bilinear", "K5 trilinear",
                        "plain gather (bilinear)", "resolve_gbuffer"]
    for k in ("phase1 planning", "full sample_atlas_tiled", "K5 nearest",
              "K5 bilinear", "K5 trilinear"):
        assert by[k]["ms"] is None and by[k]["device_ms"] is None, k
    assert all("needs the card" in by[f"K5 {m}"]["note"]
               for m in bench_texsample.MODES)
    for k in ("plain gather (bilinear)", "resolve_gbuffer"):
        assert by[k]["ms"] > 0 and by[k]["device_ms"] is None, k
    assert "128x64, 8192 pixels" in capsys.readouterr().out


def _assigned(path, name):
    """(line, value) of the assignment `name = [...]` in a JAX tool."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == name):
            return node.lineno, eval(compile(
                ast.Expression(node.value), path, "eval"),
                {"__builtins__": {}, "dict": dict})
    raise LookupError(f"{name} not in {path}")


def _loop_list(path, var):
    """(line, list) of `for var in [...]` in a JAX tool."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.For)
                and getattr(node.target, "id", None) == var
                and isinstance(node.iter, ast.List)):
            return node.lineno, ast.literal_eval(node.iter)
    raise LookupError(f"for {var} in [...] not in {path}")


def test_parts_names_every_jax_variant():
    """bench_texkernel_parts.VARIANTS: the JAX tool's 16 runs
    (tools/bench_texkernel_parts.py:236) in its order, each mapped to a
    port variant that has the JAX run's shape: tps -> pixels a thread,
    mm2 rhs -> the interleaved store, fold -> the 3-lane split, each
    stage switched off -> the port's stage off, the full runs full."""
    line, want = _assigned("tools/bench_texkernel_parts.py", "variants")
    assert line == 236
    got = bench_texkernel_parts.VARIANTS
    assert [label for label, _ in got] == [label for label, _ in want]
    stages = {"do_dma": "loads", "do_u": "address", "do_mm1": "vblend",
              "do_vw": "hblend", "do_mm2": "unpack"}
    for (label, kw), (_, name) in zip(want, got):
        v = ptex.VARIANTS[name]
        assert label == "warmup (discard)" or label in v.tpu, label
        off = {k for k, s in stages.items() if not kw.get(k, True)}
        assert v.px == kw.get("tps", 1), label
        if not off:
            assert v.full, label
            mode = kw.get("mm2_mode", "lhs")
            assert v.lanes == (3 if mode == "fold" else 1), label
            assert v.store == ("interleaved" if mode == "rhs"
                               else "planar"), label
        elif off == set(stages) and "do_dma" in off:
            assert v.skip == ("tap",) and v.store == "guard", label
        elif off == set(stages) - {"do_dma"}:
            assert v.skip == ("unpack",) and v.store == "guard", label
        else:
            assert v.skip == tuple(stages[k] for k in off), label
            assert v.store == "planar" and not v.full, label


def test_mm2_names_every_jax_mode():
    """bench_texmm2.MODES: the JAX tool's six runs (tools/bench_texmm2.py:
    206) in its order, lhs the production layout, pad / padb the
    interleaved f32 / bf16 stores, fold the 3-lane split, floor one f32 a
    pixel."""
    line, want = _loop_list("tools/bench_texmm2.py", "mode")
    assert line == 206
    assert [m for m, _ in bench_texmm2.MODES] == want
    spec = {"lhs": ("planar", 1, True), "pad": ("interleaved", 1, True),
            "padb": ("interleaved_bf16", 1, True),
            "fold": ("planar", 3, True), "floor": ("sum", 1, False)}
    for mode, name in bench_texmm2.MODES:
        v = ptex.VARIANTS[name]
        assert (v.store, v.lanes, v.full) == spec[mode], mode
        assert v.px == 1 and not v.skip and f"mm2={mode}" in v.tpu, mode


@pytest.mark.parametrize("path,line,fn,call", [
    ("tools/bench_texkernel_parts.py", 32, "make_variant", 173),
    ("tools/bench_texmm2.py", 38, "make", 153),
])
def test_the_cited_tpu_kernels(path, line, fn, call):
    """The two TPU kernels the variants replace are where the port's
    docs and chip_smoke.py's JSON say: the function at `line`, its
    pl.pallas_call at `call`."""
    with open(os.path.join(ROOT, path)) as f:
        src = f.read()
    lines = src.splitlines()
    assert lines[line - 1].startswith(f"def {fn}(")
    assert "pl.pallas_call(" in lines[call - 1]
    assert src.count("pl.pallas_call(") == 1


def _toy(M=3, size=64, seed=0, n=777):
    rng = np.random.default_rng(seed)
    n_levels = int(np.log2(size)) + 1
    stride = sum((size >> k) ** 2 for k in range(n_levels))
    atlas = PackedMaterialAtlas(
        packed=rng.integers(0, 256, (16, M * stride), dtype=np.uint8),
        size=size, num_materials=M, layer_stride=stride, n_levels=n_levels)
    table = torch.from_numpy(expand_atlas_bilinear(atlas))
    mid = torch.from_numpy(rng.integers(0, M, n).astype(np.int32))
    uv = torch.from_numpy(rng.uniform(-3, 4, (2, n)).astype(np.float32))
    lod = torch.from_numpy(rng.uniform(-1, 8, n).astype(np.float32))
    kw = dict(size=size, layer_stride=stride, n_levels=n_levels)
    return table, mid, uv, lod, kw


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "trilinear"])
@pytest.mark.parametrize("n", [1, 3, 5, 777])
def test_plain_layouts_equal_the_tap_rearranged(mode, n):
    """On CPU tensors every full variant's wrapper returns its plain
    version: the planar ones sample_packed_atlas, the interleaved one
    its transpose with a zero lane 11, the bf16 one that cast (round to
    nearest even: bf16 of the f32 value, not of a double); every ablated
    variant raises (it has none), and nothing counts as a launch."""
    table, mid, uv, lod, kw = _toy(n=n)
    planar = pgbuf.sample_packed_atlas(table, mid, uv, lod,
                                       filter_mode=mode, **kw)
    inter = torch.cat([planar.T, torch.zeros(n, 1)], dim=1)
    bf16 = torch.from_numpy(
        ((inter.numpy().view(np.uint32).astype(np.uint64) + 0x7FFF
          + ((inter.numpy().view(np.uint32) >> 16) & 1)) >> 16)
        .astype(np.uint16).view(np.int16)).view(torch.bfloat16)
    want = {"planar": planar, "interleaved": inter, "interleaved_bf16": bf16}
    kb.reset_launches()
    for name, v in ptex.VARIANTS.items():
        if not v.full:
            with pytest.raises(ValueError, match="no plain version"):
                ptex.sample_atlas_variant(table, mid, uv, lod, variant=name,
                                          filter_mode=mode, **kw)
            continue
        got = ptex.sample_atlas_variant(table, mid, uv, lod, variant=name,
                                        filter_mode=mode, **kw)
        w = want[v.store]
        assert got.dtype == w.dtype and got.shape == w.shape, name
        assert torch.equal(got, w), name
    assert sum(kb.variant_launches.values()) == 0


def test_texsample_cu_variant_table():
    """texsample.cu's texsample_variant_launch switch (it compiles only
    on the card's machine) instantiates, for each id, exactly the
    template ops/texsample.VARIANTS states (store, pixels, lanes, stages
    off), named in its comment; texsample_launch instantiates the
    production choices alone; the stage bits (texsample.cuh, the tap
    code K5 shares with K9) and store ids agree with STORE_IDS /
    SKIP_BITS; the export is typed with 13 arguments."""
    csrc = os.path.join(os.path.dirname(kb.__file__), "csrc")
    with open(os.path.join(csrc, "texsample.cu")) as f:
        src = f.read()
    with open(os.path.join(csrc, "texsample.cuh")) as f:   # the stage bits
        header = f.read()
    assert '#include "texsample.cuh"' in src
    consts = dict(re.findall(r"constexpr int (k\w+) = (0x[0-9a-f]+|\d+);",
                             src + header))
    stores = {"planar": "kPlanar", "interleaved": "kInterleaved",
              "interleaved_bf16": "kInterleavedBf16", "sum": "kSum",
              "guard": "kGuard"}
    bits = {"loads": "kNoLoads", "address": "kNoAddr", "vblend": "kNoVBlend",
            "hblend": "kNoHBlend", "unpack": "kNoUnpack", "tap": "kNoTap"}
    assert {s: int(consts[c]) for s, c in stores.items()} == ptex.STORE_IDS
    assert {s: int(consts[c]) for s, c in bits.items()} == ptex.SKIP_BITS
    cases = re.findall(r"case (\d+): return launch_tap<(\w+), (\d), (\d), "
                       r"([\w |]+)>\(a, st\);\s*// (\w+)", src)
    assert len(cases) == len(ptex.VARIANTS)
    for vid, store, px, lanes, skip, name in cases:
        v = ptex.VARIANTS[name]
        assert (v.id, stores[v.store], v.px, v.lanes) == \
            (int(vid), store, int(px), int(lanes)), name
        want = " | ".join(bits[s] for s in v.skip) or "0"
        assert skip == want, name
    body = src[src.index("SOC_EXPORT int texsample_launch("):
               src.index("SOC_EXPORT int texsample_variant_launch(")]
    assert re.findall(r"launch_tap<[^>]*>", body) == \
        ["launch_tap<kPlanar, 1, 1, 0>"]
    assert len(kb._SIGNATURES["texsample_variant_launch"]) == 13


def test_benches_refuse_without_a_card(monkeypatch, captures):
    """Without a card the two variant benches raise before they build
    anything (their subject is the kernel), as do the capture and
    bench_texsample unless told --device cpu."""
    *_, path = captures
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_build(*a, **k):
        raise AssertionError("built a scene")

    monkeypatch.setattr(pscenes, "build", no_build)
    for main in (bench_texkernel_parts.main, bench_texmm2.main,
                 bench_texsample.main, capture_texfields.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--fields", str(path)] if main is not
                 capture_texfields.main else [])


def test_texture_tools_import_no_jax():
    """The four tools and what they import leave jax and the JAX
    package out."""
    code = ("import sys\n"
            "from soc_real_time_renderer_tpu_torch.tools import "
            "capture_texfields, bench_texsample, bench_texkernel_parts, "
            "bench_texmm2\n"
            "from soc_real_time_renderer_tpu_torch.ops import texsample\n"
            "from soc_real_time_renderer_tpu_torch.utils import metrics\n"
            "assert 'torch' in sys.modules\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'soc_real_time_renderer_tpu.')) or m == "
            "'soc_real_time_renderer_tpu']\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def test_variant_bytes():
    """The bytes each variant's bound counts: inputs once, each distinct
    row's 48 bytes, the store once."""
    P, rows, N = 1000, 300, 5000

    def b(name, atlas_rows=N):
        return ptex.variant_bytes(name, P, rows, atlas_rows)

    assert b("planar") == P * 60 + rows * 48
    assert b("interleaved") == P * 64 + rows * 48
    assert b("interleaved_bf16") == P * 40 + rows * 48
    assert b("floor") == P * 20 + rows * 48
    assert b("nothing") == b("nothing_px4") == P * 16
    assert b("no_loads") == P * 60
    assert b("no_address") == P * 52 + 32 * 48      # ceil(1000 / 32) rows
    assert b("no_address", atlas_rows=7) == P * 52 + 7 * 48
    assert b("only_loads") == P * 16 + rows * 48
    assert dataclasses.is_dataclass(ptex.VARIANTS["planar"])
