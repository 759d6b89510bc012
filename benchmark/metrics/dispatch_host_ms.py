"""dispatch_host_ms: host milliseconds a traced frame inside the program's
span frame.render (graph/frame.render_frame: the proof checks, the raster
and the screen passes, launched one by one), from the program's own
totals over the traced frames (benchmark/passes.py:profiled)."""
from benchmark import passes


def read(rec):
    return passes.host_ms(rec, "frame.render")
