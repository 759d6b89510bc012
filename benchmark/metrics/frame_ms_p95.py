"""frame_ms_p95: the 95th percentile (linear interpolation), over every
frame of the window, of the time between successive end-of-frame CUDA
events (the first from the window's opening event): the frame-to-frame
time the user sees, stalls included."""
import numpy as np


def read(window):
    ms = window.get("frame_intervals_ms") or []
    return float(np.percentile(ms, 95)) if ms else None
