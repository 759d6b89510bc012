"""The one traffic generator: a mix's parameters and a seed -> the
camera input of every frame.

A mix (``traffic/<mix>.json``) is data:

- ``"camera": "orbit"``: the preset's own animation
  (``BuiltScene.frame_globals`` with ``animate``); no input.
- ``"camera": "fly"``: the viewer's fly camera through
  ``BuiltScene.apply_input``.  ``opening``: segments every seed shares,
  each ``{"frames": n, <InputState fields>}`` (a ``cursor_dx`` or
  ``cursor_dy`` is given on the segment's first frame only, the mouse
  moved once); then ``cruise``: ``keys`` held throughout, and segments
  whose ``cursor_dx`` (a frame, held for the segment) and length come
  from the lists ``cursor_dx`` and ``segment_frames``.  Every seed gets
  the same multiset of turns and lengths, each pass through them in an
  order the seed draws, so seeds differ in the path, not in the mix.
- ``start_frame``: ``[lo, hi]``, the first frame index (the globals'
  ``frame_counter`` and ``elapsed_time``), drawn from the seed.

Frame k of the traffic is the k-th frame the benchmark renders, the
warm-up's included.
"""
from __future__ import annotations

import numpy as np

INPUT_KEYS = ("forward", "back", "left", "right", "up", "down", "sprint",
              "cursor_dx", "cursor_dy", "cursor_captured")


class Traffic:
    def __init__(self, params: dict, seed: int):
        self.params = params
        self.kind = params["camera"]
        if self.kind not in ("orbit", "fly"):
            raise ValueError(f"unknown camera {self.kind!r}")
        rng = np.random.default_rng([int(seed), 1])
        lo, hi = params.get("start_frame", [1, 1])
        self.start_frame = int(rng.integers(lo, hi + 1))
        self._rng = rng
        self._inputs: list = []

    def inputs(self, k: int):
        """Frame k's input (a dict of InputState fields), or None (the
        preset's animation)."""
        if self.kind == "orbit":
            return None
        while len(self._inputs) <= k:
            self._extend()
        return self._inputs[k]

    def _segment(self, frames: int, held: dict, once: dict):
        for j in range(frames):
            inp = dict(held)
            if j == 0:
                inp.update(once)
            self._inputs.append(inp)

    def _extend(self):
        p = self.params
        if not self._inputs:
            for seg in p.get("opening", []):
                seg = dict(seg)
                n = int(seg.pop("frames"))
                once = {k: seg.pop(k) for k in ("cursor_dx", "cursor_dy")
                        if k in seg}
                self._check(seg)
                self._segment(n, seg, once)
        cruise = p["cruise"]
        keys = dict(cruise.get("keys", {}))
        self._check(keys)
        turns = self._rng.permutation(np.asarray(cruise["cursor_dx"],
                                                 np.float64))
        lengths = self._rng.permutation(np.asarray(cruise["segment_frames"],
                                                   np.int64))
        for i in range(max(len(turns), len(lengths))):
            held = dict(keys, cursor_dx=float(turns[i % len(turns)]))
            self._segment(int(lengths[i % len(lengths)]), held, {})

    @staticmethod
    def _check(d: dict):
        bad = set(d) - set(INPUT_KEYS)
        if bad:
            raise ValueError(f"unknown input fields {sorted(bad)}")
