"""The traffic generator: deterministic per seed, different across
seeds, the same mix for every seed; the views of a batched step."""
import collections

import numpy as np
import pytest

from benchmark import registry
from benchmark.traffic import Traffic

BIG = 2 ** 31 + 12345


def _path(mix, seed, n=800):
    t = Traffic(registry.traffic(mix), seed)
    return t.start_frame, [t.inputs(k) for k in range(n)]


def test_fly_is_deterministic_per_seed():
    assert _path("fly", BIG) == _path("fly", BIG)


def test_fly_differs_across_seeds():
    assert _path("fly", BIG)[1] != _path("fly", BIG + 1)[1]


def test_fly_every_seed_gets_the_same_turns_and_lengths():
    mix = registry.traffic("fly")
    cruise = mix["cruise"]
    opening = sum(s["frames"] for s in mix["opening"])
    total = sum(cruise["segment_frames"])
    for seed in (1, BIG, 7 * BIG):
        _, path = _path("fly", seed, opening + total)
        turns = collections.Counter(p["cursor_dx"] for p in path[opening:])
        # each turn of the list held for one of the listed lengths
        assert sorted(turns) == sorted(float(x) for x in cruise["cursor_dx"])
        assert sum(turns.values()) == total
        assert all(p["forward"] for p in path[opening:])


def test_fly_opening_is_shared():
    mix = registry.traffic("fly")
    n = sum(s["frames"] for s in mix["opening"])
    assert _path("fly", 3)[1][:n] == _path("fly", BIG)[1][:n]
    assert _path("fly", 3)[1][0] == {"cursor_dy": -195}


def test_orbit_start_frame_from_the_seed():
    lo, hi = registry.traffic("orbit")["start_frame"]
    starts = {_path("orbit", s, 1)[0] for s in (1, 2, 3, BIG)}
    assert len(starts) > 1 and all(lo <= s <= hi for s in starts)
    assert _path("orbit", BIG, 1) == _path("orbit", BIG, 1)
    assert _path("orbit", BIG, 3)[1] == [None] * 3


def _attrs(t):
    return t.kind, t.start_frame, t.views


@pytest.mark.parametrize("mix", ["orbit", "fly"])
def test_a_mix_without_views_gives_todays_inputs(mix):
    """No ``views`` key: one view, no turn, the same start frame and
    inputs as the mix with ``views`` 1 written out, and view 0 starts at
    the position as given, bit for bit."""
    params = registry.traffic(mix)
    plain, one = Traffic(params, BIG), Traffic(
        dict(params, views=1), BIG)
    assert _attrs(plain) == _attrs(one) == (params["camera"],
                                            one.start_frame, 1)
    assert [plain.inputs(k) for k in range(300)] == \
        [one.inputs(k) for k in range(300)]
    pos = np.array([-7.0, 1.8, 0.1], np.float32)
    homes = plain.view_positions(pos, [0.0, 1.5, 0.0])
    assert len(homes) == 1 and homes[0].tobytes() == pos.tobytes()


def test_orbit4_turns_each_view_a_quarter_about_the_target():
    """orbit4: four views; view b starts at the orbit's start turned by
    b * pi/2 about the target (same height, same distance), and the
    start frame is drawn as orbit's is for the same seed."""
    t = Traffic(registry.traffic("orbit4"), BIG)
    assert t.views == 4 and t.start_frame == _path("orbit", BIG, 1)[0]
    target = np.array([0.0, 1.5, 0.0], np.float32)
    homes = t.view_positions([-7.0, 1.8, 0.0], target)
    want = [(-7.0, 0.0), (0.0, -7.0), (7.0, 0.0), (0.0, 7.0)]
    for h, (x, z) in zip(homes, want):
        assert h.dtype == np.float32
        np.testing.assert_allclose(h, [x, 1.8, z], atol=1e-5)
    with pytest.raises(ValueError):
        Traffic(dict(registry.traffic("fly"), views=2), BIG)


@pytest.mark.parametrize("views", [2, 3, 5])
def test_the_views_are_spaced_evenly_round_the_target(views):
    """``views`` alone sets the spacing, 2 pi / views: every start is
    distinct, at the same height and distance, and the reference's
    Orbit turned by view_turn(b) starts where view b does."""
    from benchmark.reference import globals as rg
    t = Traffic(dict(registry.traffic("orbit"), views=views), BIG)
    target = np.array([0.0, 1.5, 0.0], np.float32)
    home = [-7.0, 1.8, 0.1]
    homes = t.view_positions(home, target)
    assert len({h.tobytes() for h in homes}) == views
    for b, h in enumerate(homes):
        assert t.view_turn(b) == pytest.approx(2 * np.pi * b / views)
        assert h[1] == np.float32(1.8)
        rel = h - target
        assert np.hypot(rel[0], rel[2]) == pytest.approx(np.hypot(-7, .1))
        orbit = rg.Orbit(home, target, turn=t.view_turn(b))
        assert orbit.position.tobytes() == h.tobytes()
