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

:func:`snapshot` returns the totals, the counters and the kernel
launches together; :func:`profiled` returns the same for the latest
stretch in which a profiler recorded (from the first span that saw it
record to the first that saw it stop), so a reader of a trace gets the
host time and the copies of exactly the traced frames.
"""
from __future__ import annotations

import collections
import time
import weakref

import numpy as np
import torch

from ..kernels import build as kb

PREFIX = "soc:"

totals: dict[str, list] = {}            # name -> [host seconds, calls]
counters: collections.Counter = collections.Counter()

_recording = torch._C._autograd._profiler_enabled
_Event = torch._C._profiler._RecordFunctionFast
_stretch_totals: dict[str, list] = {}   # totals of the latest stretch
_stretch_start = None     # (counters, launches) when the open one began
_stretch_end = None       # (start, end) states of the closed one


class span:
    """``with span(name):`` adds the block's host seconds to
    ``totals[name]``, and while a profiler records, its event."""
    __slots__ = ("name", "_t0", "_event")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        on = _recording()
        if on == (_stretch_start is None):
            _turn(on)
        self._event = None
        if on:
            self._event = _Event(PREFIX + self.name)
            self._event.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        _add(totals, self.name, dt)
        if self._event is not None:
            self._event.__exit__(*exc)
            _add(_stretch_totals, self.name, dt)


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
    read from a device counts in ``d2h_reads.<site>``)."""
    host = mirrored(t)
    if host is not None:
        counters["d2h_mirrored." + site] += 1
        return host.copy()
    if t.device.type != "cpu":
        counters["d2h_reads." + site] += 1
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
    """A span saw the profiler start (a new stretch opens) or stop."""
    global _stretch_start, _stretch_end
    if on:
        _stretch_totals.clear()
        _stretch_start, _stretch_end = _state(), None
    else:
        _stretch_start, _stretch_end = None, (_stretch_start, _state())


def _view(table, state) -> dict:
    c, launches = state
    return {"totals": {n: {"host_s": s, "calls": k}
                       for n, (s, k) in table.items()},
            "counters": c, "launches": launches}


def snapshot() -> dict:
    """{"totals": {name: {"host_s", "calls"}}, "counters", "launches"}
    since the process started (or :func:`reset`)."""
    return _view(totals, _state())


def profiled() -> dict | None:
    """As :func:`snapshot`, over the latest stretch in which a profiler
    recorded (the open one while it still records); None before any."""
    if _stretch_start is not None:
        a, b = _stretch_start, _state()
    elif _stretch_end is not None:
        a, b = _stretch_end
    else:
        return None
    return _view(_stretch_totals, tuple(
        {k: v - x.get(k, 0) for k, v in y.items() if v != x.get(k, 0)}
        for x, y in zip(a, b)))


def reset() -> None:
    """Clear the totals, the counters and the profiled stretch."""
    global _stretch_start, _stretch_end
    totals.clear()
    counters.clear()
    _stretch_totals.clear()
    _stretch_start = _stretch_end = None
