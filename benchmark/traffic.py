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
- ``views`` (default 1), orbit only: a step renders that many views of
  the scene at once (the render farm's batched step), spaced evenly
  round the target: view b's orbit is the preset's, its start turned by
  2 pi b / ``views`` about the camera's target around the vertical
  axis, so every view advances together.

Frame k of the traffic is the k-th frame (a step of every view) the
benchmark renders, the warm-up's included.
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
        self.views = int(params.get("views", 1))
        if self.views < 1 or (self.views > 1 and self.kind != "orbit"):
            raise ValueError(f"{self.views} views of a {self.kind!r} "
                             f"camera: only an orbit takes several views")

    def view_turn(self, b: int) -> float:
        """View b's turn about the target, in radians: 2 pi b / views."""
        return 2.0 * np.pi * b / self.views

    def view_positions(self, position, target) -> list:
        """Each view's starting camera position, in float32 as the orbit
        turns it: `position` turned by view_turn(b) about `target`
        around +y (view 0: `position` itself)."""
        position = np.asarray(position, np.float32)
        target = np.asarray(target, np.float32)
        rel = position - target
        out = [position.copy()]
        for b in range(1, self.views):
            c, s = np.cos(self.view_turn(b)), np.sin(self.view_turn(b))
            out.append(target + np.array([c * rel[0] - s * rel[2], rel[1],
                                          s * rel[0] + c * rel[2]],
                                         np.float32))
        return out

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
