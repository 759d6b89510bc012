"""The traffic generator: deterministic per seed, different across
seeds, the same mix for every seed."""
import collections

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
