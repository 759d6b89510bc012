"""frame_ms: the window's host wall time over the frames completed in it."""


def read(window):
    if not window.get("frames"):
        return None
    return window["window_s"] * 1e3 / window["frames"]
