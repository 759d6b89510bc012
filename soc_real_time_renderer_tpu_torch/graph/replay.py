"""The frame replayed as CUDA graphs, pass by pass.

``graph/frame.make_render_fn`` renders through a :class:`FrameGraphs`.
Where :func:`engages` holds (every input on one CUDA device, ``impl``
not ``"plain"``, no row split), the first call under a
:func:`capture_key` runs eagerly: the warm-up, after which
``sampling.constant``'s tensors and the kernel library exist.  The
second call captures each pass of the frame into a CUDA graph of its
own and replays it, and every later call under that key replays them.
A new key (another size, plan or scene batch) drops the graphs and
warms up again: only the newest capture is kept.  Everywhere else, and
in ``render_frame`` called directly, the frame runs eagerly.

Segments: each top-level pass of ``graph/frame._raster``, ``_shade``
and ``_sky_lut`` is a :class:`segment` (``raster.transform`` ...
``shade.history``): its ``trace.span``, and while its seam is captured,
one graph.  Every segment of a render function is captured into one
memory pool, in frame order, and each is replayed inside its own
``trace.span``, so the profiler links the graph's kernels to that span.

Seams: ``raster_stage``, ``shade_stage`` and ``_sky_lut`` are still
called every frame, through the module attributes that
``render_frame`` and ``_shade`` look up (:func:`run`), so wrappers
installed there see each frame.  Under a replay a seam does not run its
body.  It copies its inputs into the graphs' static tensors where they
are not those already, replays its segments in order (``shade_stage``
calls ``_sky_lut`` between ``shade.ssr`` and ``shade.clouds``, as at
capture) and returns fresh copies of the static outputs, so no later
replay writes a tensor that a seam has handed back.  A copy that comes
straight back as a seam's input within the frame (the same object, its
``_version`` unchanged) is read from its static tensor in place.  The
scene batch is read in place: its addresses are part of the key.  A
static input takes its caller's leaf's host mirror (``trace.mirror``),
so the proof checks read it on the host.

Counters: what a segment's code adds at capture to
``trace.counters`` (``shadow_texels``) and to ``kernels/build.launches``
is added again on each replay.  ``trace.counters["graph_captures"]``
and ``["graph_replays"]`` count the segments captured and replayed.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref

import torch

from ..kernels import build as kb
from ..utils import trace

_local = threading.local()


def active():
    """The :class:`FrameGraphs` of the frame in progress on this thread,
    or None."""
    return getattr(_local, "graphs", None)


def run(seam: str, body, args: tuple, adopt: tuple):
    """``body(*args)`` for the seam named `seam` (an attribute of
    graph/frame), eagerly or under the frame's graphs.  adopt: the
    indices of the arguments whose tensors the graphs read from static
    copies (the others, the plan, the scene batch, are read as given)."""
    graphs = active()
    if graphs is None:
        return body(*args)
    return graphs.stage(seam, body, args, adopt)


def adopt(value):
    """`value`, which the seam called last inside the seam being captured
    returned, as the graphs read it: its static tensors.  Eagerly and
    under a replay, `value` itself."""
    graphs = active()
    if graphs is None or graphs.recording is None:
        return value
    call = graphs.recording.items[-1]
    assert isinstance(call, _Call), "adopt() follows a seam's call"
    statics = iter(_leaves(call.stage.out))

    def static(t):
        s = next(statics)
        if t is not s and graphs.static_of(t) is not s:
            s.copy_(t)
        return s
    return _map(static, value)


class segment:
    """``with segment(name):`` one top-level pass of the frame: its
    ``trace.span``, and while its seam is captured, one CUDA graph."""
    __slots__ = ("name", "_span", "_token")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._span = trace.span(self.name, trace.NESTED)
        self._span.__enter__()
        graphs = active()
        self._token = None
        if graphs is not None and graphs.recording is not None:
            self._token = graphs.begin(self.name)
        return self

    def __exit__(self, *exc):
        try:
            if self._token is not None:
                active().end(self._token, failed=exc[0] is not None)
        finally:
            self._span.__exit__(*exc)


def engages(plan, impl, devices) -> bool:
    """Whether a frame of `plan` whose tensors lie on `devices` (a set)
    is replayed: one CUDA device, `impl` not "plain", no row split."""
    from .frame import _shard
    if impl == "plain" or _shard(plan) is not None or len(devices) != 1:
        return False
    return next(iter(devices)).type == "cuda"


def capture_key(plan, impl, batch, inputs):
    """The key the frame's graphs are captured under, or None where the
    frame stays eager (:func:`engages`).  inputs: (g, history,
    model_mats, normal_mats), copied into static tensors each frame: each
    leaf's shape, dtype and first leaf of the same object count.  The
    scene batch is read in place: each tensor's address, shape, strides
    and dtype count."""
    return _key(plan, impl, _leaves(inputs), _leaves(batch))


def _key(plan, impl, leaves, held):
    devices = {t.device for t in leaves} | {t.device for t in held}
    if not engages(plan, impl, devices):
        return None
    first: dict = {}
    return (id(plan), impl, next(iter(devices)),
            tuple((t.shape, t.dtype, first.setdefault(id(t), i))
                  for i, t in enumerate(leaves)),
            tuple((t.data_ptr(), t.shape, t.stride(), t.dtype)
                  for t in held))


@dataclasses.dataclass
class _Segment:
    name: str
    graph: object
    counters: dict
    launches: dict


@dataclasses.dataclass
class _Stage:
    """A seam's capture: its segments and the seams it calls, in order;
    a static tensor per adopted input tensor; its arguments with those
    in place; its return value, whose tensors are the static outputs."""
    items: list = dataclasses.field(default_factory=list)
    slots: list = dataclasses.field(default_factory=list)
    args: tuple = ()
    out: object = None


@dataclasses.dataclass
class _Call:
    seam: str
    stage: _Stage


class FrameGraphs:
    """The graphs of one render function (see the module docstring).
    seams: the module whose attributes are the seams (graph/frame)."""

    def __init__(self, seams):
        self.seams = seams
        self.key = None
        self._drop()

    def _drop(self):
        self.stages: dict = {}
        self.inputs = None        # a static tensor per input leaf
        self.static_inputs = None     # (g, history, mats) of those
        self.origin: dict = {}    # id(static input) -> the caller's leaf
        self.pool = self.stream = None
        self.recording = None     # the _Stage being captured
        self.complete = False     # a frame under graphs has returned
        self.statics: dict = {}   # id -> each static tensor
        self.copies: dict = {}    # id -> (weakref, _version, static)

    def render(self, plan, impl, batch, g, history, model_mats,
               normal_mats):
        """render_frame(plan, batch, g, history, ...) of the seams'
        module: eagerly, or replayed."""
        frame = self.seams.render_frame
        inputs = (g, history, model_mats, normal_mats)
        leaves = _leaves(inputs)
        key = _key(plan, impl, leaves, _leaves(batch))
        if key is None or key != self.key:
            self._drop()
            self.key = key
            # eagerly: under a new key, the warm-up
            return frame(plan, batch, *inputs, impl=impl)
        self.copies = {}
        if self.inputs is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(key[2])
            made: dict = {}
            for t in leaves:        # one static per object (the key's)
                if id(t) not in made:
                    made[id(t)] = t.clone()
            self.inputs = [made[id(t)] for t in leaves]
            self._keep(self.inputs)
            slots = iter(self.inputs)
            self.static_inputs = _map(lambda t: next(slots), inputs)
        else:
            pairs: dict = {}
            for t, s in zip(leaves, self.inputs):
                pairs.setdefault(id(s), (s, t))
            _copy([s for s, _ in pairs.values()],
                  [t for _, t in pairs.values()])
        for t, s in zip(leaves, self.inputs):
            host = trace.mirrored(t)
            if host is not None:        # the proof checks read it
                trace.mirror(s, host)
        self.origin = {id(s): t for t, s in zip(leaves, self.inputs)}
        _local.graphs = self
        try:
            out = frame(plan, batch, *self.static_inputs, impl=impl)
        except BaseException:
            if not self.complete:          # a failed capture: start over
                self._drop()
                self.key = None
            raise
        finally:
            _local.graphs = None
        if not self.complete:
            # the eager warm-up's blocks, which no replay reuses, go back
            # to the device: what stays reserved is the graphs' pool and
            # what is live
            torch.cuda.empty_cache()
        self.complete = True
        return out

    # --- copies that stand for static tensors --------------------------

    def register(self, t, static):
        """`t` holds what `static` holds, for the rest of this frame
        unless `t` is written."""
        self.copies[id(t)] = (weakref.ref(t), t._version, static)

    def static_of(self, t):
        """The static tensor that `t` is, or is an unchanged copy of this
        frame, or None."""
        if self.statics.get(id(t)) is t:
            return t
        e = self.copies.get(id(t))
        if e is not None and e[0]() is t and e[1] == t._version:
            return e[2]
        return None

    # --- seams ------------------------------------------------------------

    def stage(self, seam, body, args, adopt):
        outer = self.recording
        leaves = _leaves([args[i] for i in adopt])
        st = self.stages.get(seam)
        if st is None:
            st = self._capture(seam, body, args, adopt)
        else:
            self._feed(st, leaves)
            for item in st.items:
                if isinstance(item, _Segment):
                    with trace.span(item.name, trace.NESTED):
                        self._replay(item)
                else:
                    self._call(item)
        if outer is not None:
            outer.items.append(_Call(seam, st))
        return self._hand_out(st, leaves)

    def _capture(self, seam, body, args, adopt):
        st = _Stage()
        args = list(args)

        def slot(t):
            s = self.static_of(t)
            if s is None:
                s = t.clone()
            st.slots.append(s)
            return s
        for i in adopt:
            args[i] = _map(slot, args[i])
        st.args = tuple(args)
        outer, self.recording = self.recording, st
        try:
            st.out = body(*st.args)
        finally:
            self.recording = outer
        self._keep(st.slots + _leaves(st.out))
        self.stages[seam] = st
        return st

    def _keep(self, statics):
        self.statics.update((id(s), s) for s in statics)

    def _feed(self, st, leaves):
        """Copy the seam's input tensors into its static ones, where they
        are not those or unchanged copies of them."""
        if len(leaves) != len(st.slots):
            raise RuntimeError("a seam's inputs changed structure under "
                               "the same capture key")
        pairs = [(s, t) for t, s in zip(leaves, st.slots)
                 if t is not s and self.static_of(t) is not s]
        _copy([s for s, _ in pairs], [t for _, t in pairs])

    def _call(self, call):
        """Replay a seam that the seam being replayed calls: through the
        module attribute, so its wrappers run; what it returns is read
        where the captured graphs read it."""
        res = getattr(self.seams, call.seam)(*call.stage.args)
        pairs = [(s, r) for r, s in zip(_leaves(res), _leaves(call.stage.out))
                 if r is not s and self.static_of(r) is not s]
        _copy([s for s, _ in pairs], [r for _, r in pairs])

    def _hand_out(self, st, leaves):
        """The seam's return value with fresh copies of its static
        outputs; an output that is one of its inputs is that input (the
        caller's own, for the frame's inputs)."""
        given = {}
        for t, s in zip(leaves, st.slots):
            given.setdefault(id(s), self.origin.get(id(t), t))
        made, dst, src = {}, [], []

        def out(s):
            t = given.get(id(s), made.get(id(s)))
            if t is None:
                t = made[id(s)] = torch.empty_like(s)
                dst.append(t)
                src.append(s)
            return t
        res = _map(out, st.out)
        _copy(dst, src)
        for t, s in zip(dst, src):
            self.register(t, s)
        return res

    # --- segments ---------------------------------------------------------

    def begin(self, name):
        """Start capturing segment `name` on the side stream."""
        graph = torch.cuda.CUDAGraph()
        caller = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(caller)
        ctx = torch.cuda.stream(self.stream)
        ctx.__enter__()
        try:
            # thread_local: other threads' CUDA calls (the viewer's HTTP
            # threads) are not refused while a pass is captured
            graph.capture_begin(self.pool, capture_error_mode="thread_local")
        except BaseException:
            ctx.__exit__(None, None, None)
            raise
        return name, graph, caller, ctx, _counts()

    def end(self, token, failed: bool):
        """End the capture; unless the pass raised, keep the segment and
        replay it, so the capturing frame is rendered too."""
        name, graph, caller, ctx, before = token
        try:
            try:
                graph.capture_end()
            except Exception:
                if not failed:
                    raise          # else the pass's own error propagates
        finally:
            ctx.__exit__(None, None, None)
            caller.wait_stream(self.stream)
        if failed:
            return
        counters, launches = (_diff(a, b) for a, b in zip(before, _counts()))
        seg = _Segment(name, graph, counters, launches)
        self.recording.items.append(seg)
        trace.counters["graph_captures"] += 1
        self._replay(seg, recount=False)   # the capture counted them once

    def _replay(self, seg, recount=True):
        seg.graph.replay()
        trace.counters["graph_replays"] += 1
        if recount:
            for k, v in seg.counters.items():
                trace.counters[k] += v
            for k, v in seg.launches.items():
                kb.launches[k] += v


def _counts():
    return dict(trace.counters), dict(kb.launches)


def _diff(a, b) -> dict:
    return {k: v - a.get(k, 0) for k, v in b.items() if v != a.get(k, 0)}


def _copy(dst, src):
    """dst[i].copy_(src[i]) for every i: one foreach launch per pair of
    dtypes; inside a frame (a seam's copies), a bracket of the device
    clock."""
    if not dst:
        return
    groups: dict = {}
    for d, s in zip(dst, src):
        ds, ss = groups.setdefault((d.dtype, s.dtype), ([], []))
        ds.append(d)
        ss.append(s)
    with trace.bracket("replay.copy"):
        for ds, ss in groups.values():
            torch._foreach_copy_(ds, ss)


_FIELDS: dict = {}


def _fields(x):
    """The field names of dataclass instance `x`, or None."""
    t = type(x)
    names = _FIELDS.get(t, ())
    if names == ():
        names = _FIELDS[t] = (
            tuple(f.name for f in dataclasses.fields(t))
            if dataclasses.is_dataclass(t) else None)
    return names


def _leaves(obj, out=None) -> list:
    """The tensors of a tree of dataclasses, lists, tuples and dicts, in
    order.  (A plain recursion: a nested one would be a reference cycle
    that keeps the tensors alive until the collector runs.)"""
    out = [] if out is None else out
    if isinstance(obj, torch.Tensor):
        out.append(obj)
        return out
    names = _fields(obj)
    if names is not None:
        for n in names:
            _leaves(getattr(obj, n), out)
    elif isinstance(obj, (list, tuple)):
        for y in obj:
            _leaves(y, out)
    elif isinstance(obj, dict):
        for y in obj.values():
            _leaves(y, out)
    return out


def _map(fn, x):
    """The tree `x` with each tensor t replaced by fn(t), in
    :func:`_leaves`' order."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    names = _fields(x)
    if names is not None:
        return dataclasses.replace(x, **{n: _map(fn, getattr(x, n))
                                         for n in names})
    if isinstance(x, (list, tuple)):
        items = [_map(fn, y) for y in x]
        return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
    if isinstance(x, dict):
        return {k: _map(fn, y) for k, y in x.items()}
    return x
