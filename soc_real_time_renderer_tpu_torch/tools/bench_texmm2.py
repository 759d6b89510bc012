"""K5's stores on the card: the material tap with its output in other
layouts, on a real frame's tap fields.

    python -m soc_real_time_renderer_tpu_torch.tools.bench_texmm2 \\
        [--scene full] [--width 1920] [--height 1088] [--frame 1] \\
        [--fields $TMPDIR/texfields.npz] [--filter bilinear] [--reps 20]

The counterpart of the JAX package's ``tools/bench_texmm2.py``, whose
``make`` built the TPU kernel (``ops/texsample.py`` ``_tile_kernel``)
with five ways to do its last matmul, the channel select.  On the card
there is no matmul to select channels: what the five become is where
and how the tap's 11 channels are stored.  Its six runs (:data:`MODES`,
in its order), each a variant of ``kernels/csrc/texsample.cu``'s
template (``ops/texsample.VARIANTS``):

* ``lhs`` (twice, the first a warm-up): the production layout, (11, P)
  f32, one pixel a thread;
* ``pad``: interleaved (P, 12) f32, lane 11 zero, timed alone and, as
  the JAX tool's "channel slice done by XLA", with PyTorch's
  ``[:, :11].T`` made contiguous after it (the production layout again);
* ``padb``: interleaved (P, 12) bf16 (``__float2bfloat16_rn``);
* ``fold``: a pixel's row split over 3 lanes, one int4 each, planar out;
* ``floor``: the whole tap computed, one f32 a pixel stored (the
  channels' sum): the counterpart of the JAX ``zeros + rowsel[0, 0]``.

Each row as ``tools/bench_texkernel_parts.py`` prints them (card ms,
per call ms, the ratio to ``lhs``, registers, LDG and STG, and max abs
against the plain version for the full layouts: ``pad`` against the
plain tap transposed with lane 11 zero, ``padb`` against that cast to
bf16, exactly).  Needs the card: it raises without one.
"""
from __future__ import annotations

from . import bench_texkernel_parts as parts

# the JAX tool's runs (tools/bench_texmm2.py main's mode loop), each with
# the port's variant (ops/texsample.VARIANTS)
MODES = [
    ("lhs", "planar"),
    ("lhs", "planar"),
    ("pad", "interleaved"),
    ("padb", "interleaved_bf16"),
    ("fold", "lanes3"),
    ("floor", "floor"),
]


def main(argv=None, built=None) -> list[dict]:
    """Print one row per run of MODES (and ``pad`` with the channel
    slice after it) and return the rows.  `built`: the BuiltScene of
    the capture's scene and size, to use in place of building one."""
    args = parts.parser(__doc__.splitlines()[0]).parse_args(argv)
    bench = parts.VariantBench(args, built)
    rows = []
    for i, (mode, variant) in enumerate(MODES):
        label = f"mm2={mode}" + (" (discard)" if i == 0 else "")
        rows.append(bench.time(label, variant, full_ref=i == 1))
        if mode == "pad":
            call = bench.call(variant)
            rows.append(bench.time(
                "mm2=pad + [:, :11].T", variant,
                fn=lambda: call()[:, :11].T.contiguous()))
    return rows


if __name__ == "__main__":
    main()
