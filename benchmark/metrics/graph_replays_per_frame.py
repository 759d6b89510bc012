"""graph_replays_per_frame: CUDA graphs replayed a traced frame, counted
by the program where it replays them (utils/trace.counters
["graph_replays"]: graph/replay.py, one for each pass of a frame that
make_render_fn replays), over the traced frames
(benchmark/passes.py:count); 0 is a reading (every pass ran eagerly).
Nothing to read from a program without graph/replay.py."""
import importlib.util

from benchmark import passes

MODULE = "soc_real_time_renderer_tpu_torch.graph.replay"


def read(rec):
    try:
        found = importlib.util.find_spec(MODULE) is not None
    except ImportError:
        found = False
    return passes.count(rec, "graph_replays") if found else None
