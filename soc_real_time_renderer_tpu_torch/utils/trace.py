"""Host time per pass and counts of the copies, on the frame path.

``span(name)`` wraps a pass, a stage or a step of the set-up.  It always
adds its host seconds and one call to ``totals[name]``: two
``perf_counter`` calls, a dict update and one C call that asks whether a
``torch.profiler`` records.  Only while one records does the span also
enter a profiler event named ``"soc:" + name``.  There is no switch:
tracing is on exactly while a profiler records.

The events share the profiler's clock with CUPTI's device events (the
kernels and copies), so a trace can put each stretch of device idle time
down to the span the host was in then.  They are FUNCTION-scope events
(``torch._C._profiler._RecordFunctionFast``), not the user annotations
of ``torch.profiler.record_function``: the profiler mirrors a user
annotation on the device line as a range spanning the kernels launched
inside it, which a reader of that line would take for device work.  A
FUNCTION-scope event has no such mirror; the kernels launched directly
under it, with no aten op between (the ctypes launches of
``kernels/build.py``), are linked to it.

``counters`` holds plain integers, incremented where the work happens,
as ``kernels/build.launches`` counts the hand kernels' launches:

- ``h2d_copies``, ``h2d_bytes``: copies from the host to a device and
  the bytes of the leaves they carry: ``config.upload``'s one packed,
  non-blocking copy of a tree (a frame's globals and its model and
  normal matrices, ``BuiltScene.frame_globals``), and
  ``config.tree_to``'s one copy a leaf, each of which, from pageable
  memory, waits for the device's queue to drain;
- ``d2h_reads.<site>``: device-to-host reads on the frame path
  (:func:`read_back`), by the function that reads: the proof checks of
  ``graph/frame.py``, the only reads ``render_frame`` and
  ``BuiltScene.frame_globals`` make;
- ``d2h_mirrored.<site>``: the same reads served by the host's copy of
  a tensor that ``config.upload`` made and nothing wrote since
  (:func:`mirror`), which do not wait for the device;
- ``shadow_texels``: the texels of the sun's map that the shadow view
  (span ``raster.shadow`` ⊃ ``shadow.setup``, ``shadow.resolve``) can
  cover, a rendered map: the plan's proved crop, or the whole map.
  Known on the host from the plan; nothing where the map is elided.
- ``light_pairs``, ``spot_light_pairs``, ``light_pixels``:
  composition's local lights (span ``compose.lights``, K7): the (light
  slot, pixel) pairs the plan binds, (``max_point_lights`` +
  ``max_spot_lights``) x pixels x views, the spot slots' share of them,
  ``max_spot_lights`` x pixels x views, and the pixels x views they are
  shaded on.  From the plan, no read-back;
  nothing where both bounds are 0.
- ``ssr_pixels``: the pixels x views of each screen-space reflection
  march (span ``shade.ssr``, K8), reflective or not, from the targets'
  shapes, no read-back; nothing where ``enable_ssr`` is off.

The device clock, the reference's per-task timestamps
(``gpu_metric.cpp``): ``span("frame.render", device)``, given a CUDA
device, records a timing ``torch.cuda.Event`` on the device's current
stream at its entry and its exit, and so does every span given
:data:`NESTED` (each top-level pass ``raster.transform`` ...
``shade.history``) and every :class:`bracket` (graph/replay's seam
copies, a :func:`read_back` from the device) directly inside it.  The
events come from a pool and go back to it once read.  A frame's events
are read once ``query()`` says its exit event has completed, at the next
frame's entry or in :func:`last_frame`: the clock never waits for the
card.  It records nothing while a profiler records (the profiler times
the device itself), on the CPU, for a span given no device, for a nested
span with no frame open around it, or on a thread other than the one
whose frame is open; ``graph/frame.render_frame`` gives no device to a
frame split in row bands or to the call that captures its CUDA graphs.
:func:`last_frame` gives the newest frame read: its device ms, each
pass's, and the rest, the card idle inside the frame.  The viewer's
``/metrics`` reads it.

Stretches: the spans from the first that sees a profiler record (or
stop) to the first that sees it stop (or start again).  :func:`profiled`
and :func:`unprofiled` give the latest stretch in which a profiler
recorded and the latest in which none did: the host totals, counters
and kernel launches of exactly those frames.  :func:`snapshot` gives
them since the process started.
"""
from __future__ import annotations

import collections
import threading
import time
import weakref

import numpy as np
import torch

from ..kernels import build as kb

PREFIX = "soc:"
NESTED = "nested"     # span(name, NESTED): a pass inside the open frame

totals: dict[str, list] = {}            # name -> [host seconds, calls]
counters: collections.Counter = collections.Counter()

_recording = torch._C._autograd._profiler_enabled
_Event = torch._C._profiler._RecordFunctionFast


class _Stretch:
    """Spans with the profiler on (or off) throughout: their host totals,
    and the counters and launches at its start (and end, once closed)."""
    __slots__ = ("totals", "start", "end")

    def __init__(self):
        self.totals: dict[str, list] = {}
        self.start, self.end = _state(), None


_latest: dict = {True: None, False: None}  # profiler on -> latest stretch
_open = None              # the open stretch
_on = None                # whether a profiler recorded at its start


class _Frame:
    """One frame's bracket: the thread and stream it runs on, its entry
    and exit events, the brackets open in it, and its passes (name,
    entry event, exit event)."""
    __slots__ = ("holder", "stream", "entry", "exit", "depth", "passes")

    def __init__(self, stream):
        self.holder = threading.get_ident()
        self.stream, self.exit, self.depth, self.passes = stream, None, 0, []
        self.entry = _event(stream)


# the device clock, under _lock: the open frame, the closed frames not
# yet read, free events by device index, and the newest frame read
_lock = threading.RLock()
_frame = None
_pending: collections.deque = collections.deque()
_pool: dict = {}
_last_frame = None


class span:
    """``with span(name):`` adds the block's host seconds to
    ``totals[name]``, and while a profiler records, its event.
    ``span("frame.render", device)``, a CUDA device, and
    ``span(name, NESTED)`` directly inside it are also brackets of the
    device clock while no profiler records."""
    __slots__ = ("name", "clock", "_t0", "_event", "_mark")

    def __init__(self, name: str, clock=None):
        self.name = name
        self.clock = clock

    def __enter__(self):
        on = _recording()
        if on is not _on:
            _turn(on)
        self._event = self._mark = None
        if on:
            self._event = _Event(PREFIX + self.name)
            self._event.__enter__()
        elif self.clock is NESTED:
            self._mark = _enter()
        elif self.clock is not None:
            self._mark = _open_frame(self.clock)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if self._mark is None:
            pass
        elif self.clock is NESTED:
            _exit(self.name, self._mark)
        else:
            _close_frame(self._mark)
        _add(totals, self.name, dt)
        if _open is not None:
            _add(_open.totals, self.name, dt)
        if self._event is not None:
            self._event.__exit__(*exc)


class bracket:
    """``with bracket(name):`` a bracket of the device clock directly
    inside the open frame, as ``span(name, NESTED)``, with no host total
    and no profiler event: device work a frame enqueues outside its
    passes."""
    __slots__ = ("name", "_mark")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._mark = _enter()
        return self

    def __exit__(self, *exc):
        if self._mark is not None:
            _exit(self.name, self._mark)


def _event(stream):
    """A timing event from the pool, recorded on `stream`."""
    with _lock:
        free = _pool.get(stream.device_index)
        ev = free.pop() if free else torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


def _open_frame(device):
    """The frame that a span given `device` opens, its entry recorded, or
    None where it opens none (no CUDA device, or a frame already open)."""
    global _frame
    if getattr(device, "type", None) != "cuda":
        return None
    stream = torch.cuda.current_stream(device)
    with _lock:
        if _frame is not None:
            return None
        _fold()
        _frame = _Frame(stream)
        return _frame


def _close_frame(f):
    global _frame
    f.exit = _event(f.stream)
    with _lock:
        if _frame is f:                 # else reset() dropped it
            _pending.append(f)
            _frame = None


def _enter():
    """The open frame with a bracket opened in it, its entry event
    recorded where the bracket lies directly inside the frame (a pass),
    or None where this thread has no frame open."""
    f = _frame
    if f is None or f.holder != threading.get_ident():
        return None
    f.depth += 1
    if f.depth == 1:
        f.passes.append([None, _event(f.stream), None])
    return f


def _exit(name, f):
    if f.depth == 1:
        p = f.passes[-1]
        p[0], p[2] = name, _event(f.stream)
    f.depth -= 1


def _fold():
    """Read the closed frames whose exit events have completed, in order
    (under _lock): the newest becomes the last frame, and their events go
    back to the pool."""
    global _last_frame
    done = []
    while _pending and _pending[0].exit.query():
        done.append(_pending.popleft())
    if not done:
        return
    f = done[-1]
    ms = f.entry.elapsed_time(f.exit)
    passes: dict = {}
    for name, a, b in f.passes:
        passes[name] = passes.get(name, 0.0) + a.elapsed_time(b)
    _last_frame = {"ms": ms, "idle_ms": ms - sum(passes.values()),
                   "passes": passes}
    for f in done:
        free = _pool.setdefault(f.stream.device_index, [])
        free += [f.entry, f.exit]
        free += [e for p in f.passes for e in p[1:]]


def last_frame() -> dict | None:
    """The newest frame the device clock read: {"ms": its device ms entry
    to exit, "passes": {name: device ms of its passes and brackets
    directly inside it}, "idle_ms": the rest of "ms", the card waiting
    for the host inside the frame}, or None."""
    with _lock:
        _fold()
        return _last_frame


def count_h2d(nbytes: int) -> None:
    """Count one host-to-device copy of `nbytes` bytes of leaves."""
    counters["h2d_copies"] += 1
    counters["h2d_bytes"] += nbytes


class _Ref(weakref.ref):
    """A weak reference that knows its registry key."""
    __slots__ = ("key",)


def _gone(ref: _Ref) -> None:
    e = _mirrors.get(ref.key)
    if e is not None and e[0] is ref:
        del _mirrors[ref.key]


# id(tensor) -> (_Ref, its _version then, the host's numpy copy); an
# entry goes with its tensor
_mirrors: dict = {}


def mirror(t: torch.Tensor, host: np.ndarray) -> None:
    """Record that `t` holds `host`'s values until `t` (or a view that
    shares its version counter) is written in place."""
    ref = _Ref(t, _gone)
    ref.key = id(t)
    _mirrors[ref.key] = (ref, t._version, host)


def mirrored(t: torch.Tensor):
    """The host's copy of `t` (:func:`mirror`) while it still holds, or
    None."""
    e = _mirrors.get(id(t))
    if e is not None and e[0]() is t and e[1] == t._version:
        return e[2]
    return None


def read_back(t: torch.Tensor, site: str):
    """`t` as a numpy array: the host's copy where `t` has a valid one
    (counted in ``d2h_mirrored.<site>``), else read from its device (a
    read from a device counts in ``d2h_reads.<site>``, a bracket of the
    device clock inside a frame)."""
    host = mirrored(t)
    if host is not None:
        counters["d2h_mirrored." + site] += 1
        return host.copy()
    if t.device.type == "cpu":
        return t.detach().numpy()
    counters["d2h_reads." + site] += 1
    with bracket("read_back"):
        return t.detach().cpu().numpy()


def _add(table, name, dt):
    t = table.get(name)
    if t is None:
        table[name] = t = [0.0, 0]
    t[0] += dt
    t[1] += 1


def _state():
    return dict(counters), dict(kb.launches)


def _turn(on: bool) -> None:
    """A span saw the profiler start or stop: the open stretch closes and
    a new one opens."""
    global _open, _on
    if _open is not None:
        _open.end = _state()
    _open = _latest[on] = _Stretch()
    _on = on


def _view(table, state) -> dict:
    c, launches = state
    return {"totals": {n: {"host_s": s, "calls": k}
                       for n, (s, k) in table.items()},
            "counters": c, "launches": launches}


def _stretch(st) -> dict | None:
    if st is None:
        return None
    a, b = st.start, st.end or _state()
    return _view(st.totals, tuple(
        {k: v - x.get(k, 0) for k, v in y.items() if v != x.get(k, 0)}
        for x, y in zip(a, b)))


def snapshot() -> dict:
    """{"totals": {name: {"host_s", "calls"}}, "counters", "launches"}
    since the process started (or :func:`reset`)."""
    return _view(totals, _state())


def profiled() -> dict | None:
    """As :func:`snapshot`, over the latest stretch in which a profiler
    recorded (the open one while it still records); None before any."""
    return _stretch(_latest[True])


def unprofiled() -> dict | None:
    """As :func:`profiled`, over the latest stretch in which no profiler
    recorded; None before any span."""
    return _stretch(_latest[False])


def reset() -> None:
    """Clear the totals, the counters, the stretches and the device
    clock (its unread events are dropped)."""
    global _open, _on, _frame, _last_frame
    totals.clear()
    counters.clear()
    _open = _on = None
    _latest[True] = _latest[False] = None
    with _lock:
        _frame = _last_frame = None
        _pending.clear()
        _pool.clear()
