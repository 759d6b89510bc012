"""shadow_texels_per_frame: the texels of the sun's map that the shadow
view can cover, a traced frame, counted by the program where it renders
the map (utils/trace.counters["shadow_texels"]: the plan's proved crop,
or the whole map without one; known on the host, no read-back), over
the traced frames (benchmark/passes.py:profiled).  Nothing to read where
the program counted none: the map elided, or a program without the
counter."""
from benchmark import passes


def read(rec):
    frames = rec.get("frames")
    p = passes.profiled() if frames else None
    n = p["counters"].get("shadow_texels") if p else None
    return n / frames if n else None
