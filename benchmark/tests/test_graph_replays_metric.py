"""The reader of the replayed frame's engagement counter: the program's
graph_replays over the traced frames, 0 as a reading (no replay), and
nothing without a trace, or from a program without graph/replay.py."""
import sys

from torch.profiler import ProfilerActivity, profile

from benchmark import registry
from soc_real_time_renderer_tpu_torch.utils import trace

READ = registry.metric_reader("graph_replays_per_frame")


def _traced(replays, frames=4):
    """`frames` fake frames under a CPU profiler, each counting `replays`
    graph replays, then one untraced frame that the reader must not see."""
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(frames):
            with trace.span("frame.render"):
                trace.counters["graph_replays"] += replays
    with trace.span("frame.render"):
        trace.counters["graph_replays"] += replays


def test_graph_replays_per_frame_reads_the_traced_frames():
    _traced(16)
    assert READ({"frames": 4}) == 16
    assert READ({"frames": 0}) is None
    trace.reset()


def test_graph_replays_per_frame_reads_zero_for_an_eager_frame():
    _traced(0)
    assert READ({"frames": 4}) == 0
    trace.reset()


def test_graph_replays_per_frame_is_silent_without_a_trace():
    trace.reset()
    assert READ({"frames": 4}) is None


def test_graph_replays_per_frame_is_silent_without_replay(monkeypatch):
    monkeypatch.setitem(sys.modules,
                        "soc_real_time_renderer_tpu_torch.graph.replay", None)
    _traced(16)
    assert READ({"frames": 4}) is None
    trace.reset()
