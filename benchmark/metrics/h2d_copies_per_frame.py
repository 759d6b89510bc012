"""h2d_copies_per_frame: host-to-device copies a traced frame, counted by
the program where it makes them (utils/trace.counters["h2d_copies"]:
config.tree_to's host leaves and frame_globals' two matrices), over the
traced frames (benchmark/passes.py:profiled); 0 is a reading."""
from benchmark import passes


def read(rec):
    return passes.count(rec, "h2d_copies")
