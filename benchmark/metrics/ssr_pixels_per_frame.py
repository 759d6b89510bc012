"""ssr_pixels_per_frame: the pixels the screen-space reflection march
covers a traced frame, counted by the program from its targets' shapes
(utils/trace.counters["ssr_pixels"]: pixels x views of each march,
reflective or not; no read-back), over the traced frames
(benchmark/passes.py:profiled).  Nothing to read where the program
counted none: SSR off, or a program without the counter."""
from benchmark import passes


def read(rec):
    frames = rec.get("frames")
    p = passes.profiled() if frames else None
    n = p["counters"].get("ssr_pixels") if p else None
    return n / frames if n else None
