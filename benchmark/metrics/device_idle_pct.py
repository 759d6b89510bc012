"""device_idle_pct: the share of the traced window in which no operation
ran on the card (the union of the profiler's device intervals)."""


def read(rec):
    w = rec.get("window_s")
    if not w or rec.get("busy_s") is None:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / w)
