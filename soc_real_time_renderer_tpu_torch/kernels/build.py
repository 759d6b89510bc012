"""Build the CUDA sources in ``csrc/`` with nvcc and bind them by ctypes.

Each ``csrc/*.cu`` compiles to an object file in its own nvcc process,
all started together, and the objects link into one shared library with
a plain C interface (``nvcc -shared``, no PyTorch headers: seconds, not
minutes), for ``sm_90a``, into ``build/torch_ext/`` of the checkout, at
first use.  It is rebuilt when a source is newer than the library.
Every launch function takes raw device pointers and PyTorch's current
stream, launches without synchronising and returns the
``cudaGetLastError`` code, which :func:`check` turns into an exception.
Each kernel but K5 takes a view count: that many inputs and outputs lie
back to back and one launch covers them all (one frame is 1 view; K5's
views fold into its pixel axis).

``--fmad=false``: nvcc contracts ``a*b + c`` into FMA by default, which
can move an edge-function value by an ulp and flip coverage on edge
pixels against the plain PyTorch version; every kernel here is written
in its plain version's operation order and built without contraction,
so kernel and plain version agree bit for bit where they use the same
functions.

Dispatch (:func:`choose`): CUDA tensors go to the kernel, CPU tensors to
the plain version; ``impl="plain"`` forces the plain version on a card
(the comparisons in tests and ``chip_smoke.py``), ``impl="cuda"`` on a
CPU tensor raises.  There is no fallback from a failed build or launch.
"""
from __future__ import annotations

import collections
import ctypes
import glob
import os
import re
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "torch_ext")
LIB = os.path.join(BUILD_DIR, "libsoc_kernels.so")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-O3", "-std=c++17", "--fmad=false", "-Xptxas", "-v",
              "-Xcompiler", "-fPIC"]

# launch counts per kernel: each wrapper adds one where it launches
launches = {"resolve": 0, "resolve_depth": 0, "texsample": 0,
            "ssao_taps": 0, "sky_lut": 0, "sky_lut_procedural": 0,
            "taa_reproject": 0, "taa_resolve": 0, "local_lights": 0,
            "ssr_march": 0, "gbuffer_resolve": 0}
# launches of K5's variants (ops/texsample.VARIANTS, the texture-tap
# benches), by variant: apart from `launches`, whose kernels are the
# frame's
variant_launches: collections.Counter = collections.Counter()

_lib = None
build_log = ""        # nvcc's output (ptxas register / smem report)
build_seconds = None  # wall time of the last build (None: none ran)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # starts, recs, depth, tri_id, cap, num_bins, bx, bw, bh, out_w,
    # views, row0 (first bin row), band_by (bin rows), stream
    "resolve_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                       _P],
    # starts, recs, depth, cap, num_bins, bx, bw, bh, out_w, views, row0,
    # band_by, stream
    "resolve_depth_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                             _P],
    # atlas, mid, uv, lod, out, P, rows, size, layer_stride, n_levels,
    # filter mode, stream
    "texsample_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # as texsample_launch, then the variant (ops/texsample.VARIANTS' id)
    "texsample_variant_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _I, _P],
    # planes, depth, params, kern, out, h, w, H, W, k, views, stream
    "ssao_taps_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # params, noise, out, lut_w, lut_h, views, stream
    "sky_lut_launch": [_P, _P, _P, _I, _I, _I, _P],
    # params, out, lut_w, lut_h, views, stream
    "sky_lut_procedural_launch": [_P, _P, _I, _I, _I, _P],
    # history, velocity, out, C, H, W, views, row0, full_h, stream
    "taa_reproject_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # color, depth, velocity, prev color, prev velocity, frame counter,
    # out, H, W, crop, row0, full_h, views, the view strides of color,
    # depth, velocity, prev color and prev velocity, the frame counter's,
    # stream
    "taa_resolve_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _I, _I, _I, _I, _I, _I, _P],
    # albedo, normal, position, camera position, point position, colour,
    # intensity, count, spot position, direction, colour, intensity,
    # cut-off, outer cut-off, count, out, P, views, max_point, max_spot,
    # the lights' view stride (0 or 1 set), the channel and view strides
    # of albedo, normal and position, stream
    "local_lights_launch": [_P] * 16 + [_I] * 11 + [_P],
    # depth, albedo, normal, metallic-roughness, projection, inverse
    # projection, view, rank (or null), count (or null), overflow (or
    # null), out, H, W, views, cap, the matrices' view stride (0 or 16),
    # depth's view stride, the channel and view strides of albedo, normal
    # and metallic-roughness, stream
    "ssr_march_launch": [_P] * 11 + [_I] * 12 + [_P],
    # tri_id, records, atlas, prev_view_proj, albedo, emissive, normal,
    # metallic-roughness, velocity, H, W, views, records' columns (T + 1),
    # row0, full_h, prev_view_proj's view stride (0 or 16), atlas rows,
    # atlas size, layer stride, levels, filter mode (3: none), stream
    "gbuffer_resolve_launch": [_P] * 9 + [_I] * 12 + [_P],
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    variant_launches.clear()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built on this machine")
    return path


def build(sources, lib: str = LIB, extra_flags=()) -> str:
    """Compile every source in parallel, then link them into `lib`;
    returns nvcc's output.  Raises on the first failure.  extra_flags:
    more nvcc flags (a -D that picks a compile-time variant)."""
    nvcc = _nvcc()
    out_dir = os.path.dirname(lib)
    tag = f"{os.getpid()}"
    objs = [os.path.join(out_dir, os.path.basename(s) + f".{tag}.o")
            for s in sources]
    flags = [*NVCC_FLAGS, *extra_flags]
    procs = [subprocess.Popen([nvcc, *flags, "-c", s, "-o", o],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(sources, objs)]
    log, failed = [], []
    for s, p in zip(sources, procs):
        out, _ = p.communicate()
        log.append(f"== {os.path.basename(s)}\n{out}")
        if p.returncode != 0:
            failed.append(os.path.basename(s))
    try:
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "".join(log))
        tmp = f"{lib}.{tag}.tmp"
        res = subprocess.run([nvcc, *ARCH, "-shared", "-o", tmp, *objs],
                             capture_output=True, text=True)
        log.append(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               + "".join(log))
        os.replace(tmp, lib)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    return "".join(log)


def load(lib: str, optional=()) -> ctypes.CDLL:
    """The kernel library at `lib`, its launch functions typed; a
    function named in `optional` may be missing (an older tree's
    sources, kernel_ab.py)."""
    cdll = ctypes.CDLL(lib)
    for name, argtypes in _SIGNATURES.items():
        if name in optional and not hasattr(cdll, name):
            continue
        fn = getattr(cdll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    cdll.soc_error_string.argtypes = [ctypes.c_int]
    cdll.soc_error_string.restype = ctypes.c_char_p
    return cdll


def library() -> ctypes.CDLL:
    """Build (if stale) and load the kernel library."""
    global _lib, build_log, build_seconds
    if _lib is not None:
        return _lib
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    deps = sources + glob.glob(os.path.join(CSRC, "*.cuh"))
    stale = (not os.path.exists(LIB)
             or os.path.getmtime(LIB) < max(os.path.getmtime(s)
                                            for s in deps))
    if stale:
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        build_log = build(sources)
        build_seconds = time.perf_counter() - t0
    _lib = load(LIB)
    return _lib


def kernel_resources(lib: str = LIB) -> dict:
    """Per kernel function of `lib` (its mangled name): "REG", the
    registers a thread (cuobjdump -res-usage), and "LDG" and "STG", the
    number of its global load and store SASS instructions (cuobjdump
    -sass), so a reader sees which loads and stores the compiler kept."""
    ops = ("LDG", "STG")
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_nvcc()), "cuobjdump")
    out: dict[str, dict] = {}

    def run(flag):
        return subprocess.run([tool, flag, lib], capture_output=True,
                              text=True, check=True, timeout=600).stdout

    fn = None
    for ln in run("-res-usage").splitlines():
        m = re.match(r"\s*Function (\S+?):?(\s|$)", ln)
        if m:
            fn = m.group(1)
        m = re.search(r"\bREG:(\d+)", ln)
        if m and fn is not None:
            out.setdefault(fn, dict.fromkeys(ops, 0))["REG"] = int(m.group(1))
    fn = None
    opcode = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\w*)")
    for ln in run("-sass").splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            out.setdefault(fn, dict.fromkeys(ops, 0))
            continue
        m = opcode.search(ln)
        if fn is not None and m and m.group(1) in ops:
            out[fn][m.group(1)] += 1
    return out


def check(code: int, what: str) -> None:
    if code != 0:
        msg = library().soc_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: cuda error {code} "
                           f"({msg})")


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def choose(impl: str | None, *tensors) -> str:
    """"cuda" or "plain" for an op on `tensors` (see module docstring)."""
    on_cuda = [t.is_cuda for t in tensors]
    if any(on_cuda) and not all(on_cuda):
        raise ValueError("tensors on mixed devices")
    if impl is None:
        return "cuda" if all(on_cuda) else "plain"
    if impl == "plain":
        return impl
    if impl == "cuda":
        if not all(on_cuda):
            raise ValueError("impl='cuda' needs CUDA tensors; the CUDA "
                             "kernels never run on the CPU")
        return impl
    raise ValueError(f"unknown impl {impl!r} (None, 'cuda' or 'plain')")
