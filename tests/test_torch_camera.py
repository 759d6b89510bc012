"""The viewer's fly camera (``camera.InputState``, ``ControlledCamera3D``)
and ``Camera3D.get_vp`` / ``get_view`` against the JAX package's.  Both
are host numpy, so they are held bit for bit: a seeded sequence of
inputs (keys, sprint, mouse deltas large enough to hit the pitch clamp,
``cursor_captured=False`` steps) goes through both cameras, and
position, rotation and ``view_mat`` are compared after every step.
"""
import numpy as np
import pytest

from soc_real_time_renderer_tpu import camera as jcam
from soc_real_time_renderer_tpu_torch import camera as pcam

KEYS = ("forward", "back", "left", "right", "up", "down", "sprint")


def _inputs(seed, n):
    """n (InputState kwargs) from `seed`: each key down with p = 0.3,
    mouse deltas of up to 400 px (a few steps swing the pitch past
    MAX_ROT), one step in eight with the cursor released."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        kw = {k: bool(rng.random() < 0.3) for k in KEYS}
        kw["cursor_dx"] = float(rng.normal(0.0, 150.0))
        kw["cursor_dy"] = float(rng.normal(0.0, 400.0))
        kw["cursor_captured"] = bool(rng.random() >= 0.125)
        out.append(kw)
    return out


def _pair(position, rotation, w=160, h=96):
    cams = []
    for mod in (jcam, pcam):
        c = mod.Camera3D()
        c.resize(w, h)
        f = mod.ControlledCamera3D(camera=c)
        f.position = np.asarray(position, np.float32).copy()
        f.rotation = np.asarray(rotation, np.float32).copy()
        cams.append(f)
    return cams


def _same(a, b):
    return np.asarray(a).tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fly_camera_bit_equal_over_a_sequence(seed):
    jf, pf = _pair([-7.0, 1.8, 0.0], [0.0, 0.05, 0.0])
    dt = 1.0 / 60.0
    clamped = released = 0
    for kw in _inputs(seed, 120):
        jf.update(jcam.InputState(**kw), dt)
        pf.update(pcam.InputState(**kw), dt)
        assert _same(jf.position, pf.position)
        assert _same(jf.rotation, pf.rotation)
        assert _same(jf.camera.view_mat, pf.camera.view_mat)
        assert _same(jf.camera.get_vp(), pf.camera.get_vp())
        assert _same(jf.camera.get_view(), pf.camera.get_view())
        clamped += abs(float(pf.rotation[1])) == np.float32(pcam.MAX_ROT)
        released += not kw["cursor_captured"]
    assert clamped > 0 and released > 0      # both branches were taken
    assert pf.position.dtype == np.float32


def test_pitch_clamp_and_released_cursor():
    jf, pf = _pair([0.0, 0.0, 0.0], [0.0, 0.0, 0.0])
    up = dict(cursor_dx=0.0, cursor_dy=1e6)
    for f, mod in ((jf, jcam), (pf, pcam)):
        f.update(mod.InputState(**up), 0.1)
    assert pf.rotation[1] == np.float32(pcam.MAX_ROT) == jf.rotation[1]
    assert pcam.MAX_ROT == jcam.MAX_ROT == 1.56825555556
    # a released cursor neither turns nor moves the camera
    p0, r0 = pf.position.copy(), pf.rotation.copy()
    kw = dict(forward=True, sprint=True, cursor_dx=50.0, cursor_dy=-50.0,
              cursor_captured=False)
    jf.update(jcam.InputState(**kw), 0.1)
    pf.update(pcam.InputState(**kw), 0.1)
    assert _same(pf.position, p0) and _same(pf.rotation, r0)
    assert _same(jf.camera.view_mat, pf.camera.view_mat)


@pytest.mark.parametrize("key,axis,sign", [("right", None, 1),
                                          ("left", None, -1),
                                          ("up", 1, 1), ("down", 1, -1)])
def test_keys_move_like_the_reference(key, axis, sign):
    """D moves along +right (forward x up) and A along -right, the
    reference's binding; Space/Ctrl along +-y; sprint is 8 x 7.5 units a
    second."""
    jf, pf = _pair([0.0, 0.0, 0.0], [0.0, 0.0, 0.0])
    for f, mod in ((jf, jcam), (pf, pcam)):
        f.update(mod.InputState(**{key: True, "sprint": True}), 0.5)
    assert _same(jf.position, pf.position)
    step = 0.5 * 8.0 * 7.5
    # rotation 0 looks along +x: right = (1, 0, 0) x (0, 1, 0) = +z
    want = np.zeros(3, np.float32)
    want[2 if axis is None else axis] = sign * step
    np.testing.assert_allclose(pf.position, want, atol=1e-5)


def test_get_vp_and_get_view():
    for w, h in ((640, 384), (1920, 1088)):
        jc, pc = jcam.Camera3D(), pcam.Camera3D()
        jc.resize(w, h)
        pc.resize(w, h)
        assert _same(jc.get_vp(), pc.get_vp())
        assert pc.get_vp().dtype == np.float32
        assert pc.get_view() is pc.view_mat
