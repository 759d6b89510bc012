"""light_pairs_per_frame: the (light slot, pixel) pairs composition's
local lights shade a traced frame, counted by the program from its plan
(utils/trace.counters["light_pairs"]: (max_point_lights +
max_spot_lights) x pixels x views; no read-back), over the traced frames
(benchmark/passes.py:profiled).  Nothing to read where the program
counted none: a scene with no light, or a program without the
counter."""
from benchmark import passes


def read(rec):
    frames = rec.get("frames")
    p = passes.profiled() if frames else None
    n = p["counters"].get("light_pairs") if p else None
    return n / frames if n else None
