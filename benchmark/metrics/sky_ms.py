"""sky_ms: device milliseconds a traced frame of the kernels that the
profiler links to launches inside graph.frame._sky_lut (the harness's span
`sky_lut`)."""


def read(rec):
    span, frames = rec.get("spans", {}).get("sky_lut"), rec.get("frames")
    if not frames or not span or span["device_s"] <= 0:
        return None
    return span["device_s"] * 1e3 / frames
