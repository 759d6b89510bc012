"""shade_ms: device milliseconds a traced frame of the kernels that the
profiler links to launches inside graph.frame.shade_stage (the harness's span
`shade_stage`)."""


def read(rec):
    span, frames = rec.get("spans", {}).get("shade_stage"), rec.get("frames")
    if not frames or not span or span["device_s"] <= 0:
        return None
    return span["device_s"] * 1e3 / frames
