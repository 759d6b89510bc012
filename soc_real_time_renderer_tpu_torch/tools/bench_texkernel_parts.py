"""Attribute K5's cost on the card: the material tap with its stages
switched off, its stores in other layouts, or more pixels a thread, on a
real frame's tap fields.

    python -m soc_real_time_renderer_tpu_torch.tools.bench_texkernel_parts \\
        [--scene full] [--width 1920] [--height 1088] [--frame 1] \\
        [--fields $TMPDIR/texfields.npz] [--filter bilinear] [--reps 20]

The counterpart of the JAX package's ``tools/bench_texkernel_parts.py``,
whose ``make_variant`` built the TPU kernel (``ops/texsample.py``
``_tile_kernel``) with its page DMA, U build, row matmul, Vw build or
channel-select matmul switched off, or several tiles a grid step.  Here
each of its 16 runs (:data:`VARIANTS`, in its order) is a variant of
``kernels/csrc/texsample.cu``'s template (``ops/texsample.VARIANTS``
says what each leaves out): the stages of the card's kernel are the
row address, the 48-byte row loads, the unpack and blend, and the
stores.  For each: ms on the card alone (``utils/metrics.device_ms``,
median of --reps calls, L2 evicted before each), ms per wrapper call,
the ratio to the full kernel's card ms, the kernel's registers and its
SASS count of LDG and STG (``kernels/build.kernel_resources``: an
ablated variant whose loads or stores the compiler deleted would show
here), and for the variants that compute the whole tap and store all of
it, the max abs difference from their plain version (0 where right).
The ablated ones have no right answer and are timed only, as in the JAX
tool.

Reads the npz that ``tools/capture_texfields.py`` wrote for the same
scene and size.  Needs the card: it raises without one (its subject is
the kernel; it never times a plain version in a kernel's place).
"""
from __future__ import annotations

from . import capture_texfields as ct

# the JAX tool's runs (tools/bench_texkernel_parts.py main's `variants`),
# each with the port's variant (ops/texsample.VARIANTS)
VARIANTS = [
    ("warmup (discard)", "planar"),
    ("full kernel (mm2=lhs tps=1)", "planar"),
    ("mm2=rhs (P,CH out)", "interleaved"),
    ("mm2=fold (lane rolls)", "lanes3"),
    ("tps=2", "planar_px2"),
    ("tps=4", "planar_px4"),
    ("mm2=rhs tps=4", "interleaved_px4"),
    ("mm2=fold tps=4", "lanes3_px4"),
    ("no DMA", "no_loads"),
    ("no U construct (const U)", "no_address"),
    ("no mm1 (skip row matmul)", "no_vblend"),
    ("no Vw (const col weight)", "no_hblend"),
    ("no mm2 (slice channels)", "no_unpack"),
    ("only DMA (no compute)", "only_loads"),
    ("nothing (grid overhead)", "nothing"),
    ("nothing tps=4", "nothing_px4"),
]


class VariantBench:
    """The scene's atlas and the capture's fields on the card; times
    variants of texsample.cu on them and holds the full ones against
    their plain versions."""

    def __init__(self, args, built):
        import torch

        from ..kernels import build as kb
        from .bench import asset_tree, card_name, prepare
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the K5 variants run only on "
                               "the card")
        self.device = torch.device("cuda", torch.cuda.current_device())
        prepare(self.device)
        if built is None:
            with asset_tree():
                built = ct.build(args, self.device)
        plan = built.plan
        self.mid, self.uv, self.lod, (H, W) = ct.load_fields(args.fields,
                                                             self.device)
        if (H, W) != (plan.config.height, plan.config.width):
            raise ValueError(f"fields {H}x{W} for a {plan.config.height}x"
                             f"{plan.config.width} scene")
        self.atlas = built.batch.atlas_packed
        self.kw = dict(size=plan.atlas_size,
                       layer_stride=plan.atlas_layer_stride,
                       n_levels=plan.atlas_n_levels, filter_mode=args.filter)
        self.reps = args.reps
        kb.library()
        self.resources = kb.kernel_resources()
        self.full_ms = None
        print(f"{args.scene} {W}x{H}, {self.mid.numel()} pixels, "
              f"{args.filter}, atlas {tuple(self.atlas.shape)}, "
              f"{card_name(self.device)}", flush=True)

    def call(self, variant):
        from ..ops import texsample
        return lambda: texsample.sample_atlas_variant(
            self.atlas, self.mid, self.uv, self.lod, variant=variant,
            **self.kw)

    def resources_of(self, variant):
        """(registers, LDG, STG) of the variant's kernel, or Nones."""
        from ..ops import texsample
        sym = texsample.variant_symbol(texsample.VARIANTS[variant])
        hits = [r for f, r in self.resources.items() if sym in f]
        if len(hits) != 1:
            return None, None, None
        r = hits[0]
        return r.get("REG"), r["LDG"], r["STG"]

    def time(self, label, variant, fn=None, full_ref=False):
        """One row: the variant (or `fn`, a call built on it) timed on
        the card alone and per call; max abs against the plain version
        where the variant is full.  `full_ref`: this row's card ms is
        the full kernel's, which later rows are set against."""
        import torch

        from ..ops import texsample
        from ..utils import metrics
        v = texsample.VARIANTS[variant]
        compare = v.full and fn is None
        fn = fn or self.call(variant)
        got = fn()
        torch.cuda.synchronize(self.device)
        err = None
        if compare:
            want = texsample.variant_plain(self.atlas, self.mid, self.uv,
                                           self.lod, variant=variant,
                                           **self.kw)
            err = (got.float() - want.float()).abs().max().item()
        del got
        dev_ms = metrics.device_ms(fn, self.reps,
                                   metrics.l2_flush(self.device))
        if dev_ms is None:
            raise RuntimeError(f"{label}: a call timed on the card alone "
                               f"waited for the card")
        call_ms = metrics.cuda_ms(fn, self.reps)
        if full_ref:
            self.full_ms = dev_ms
        reg, ldg, stg = self.resources_of(variant)
        ratio = dev_ms / self.full_ms if self.full_ms else float("nan")
        print(f"{label:34s} {variant:17s} card {dev_ms:8.4f} ms "
              f"({ratio:5.2f}x full)  per call {call_ms:8.4f} ms  "
              f"regs {reg} LDG {ldg} STG {stg}"
              + ("" if err is None else f"  max abs vs plain {err:.3g}"
                 + ("" if err == 0 else "  MISMATCH")), flush=True)
        return {"label": label, "variant": variant, "device_ms": dev_ms,
                "ms": call_ms, "full": v.full, "max_abs_err": err,
                "registers": reg, "LDG": ldg, "STG": stg}


def parser(doc):
    ap = ct.parser(doc, "npz of mid/u/v/lod/live written by "
                        "tools/capture_texfields.py at the same scene and "
                        "size")
    ap.add_argument("--filter", default="bilinear",
                    choices=("nearest", "bilinear", "trilinear"))
    ap.add_argument("--reps", type=int, default=20)
    return ap


def main(argv=None, built=None) -> list[dict]:
    """Print one row per run of VARIANTS and return the rows.  `built`:
    the BuiltScene of the capture's scene and size, to use in place of
    building one."""
    args = parser(__doc__.splitlines()[0]).parse_args(argv)
    bench = VariantBench(args, built)
    return [bench.time(label, variant, full_ref=i == 1)
            for i, (label, variant) in enumerate(VARIANTS)]


if __name__ == "__main__":
    main()
