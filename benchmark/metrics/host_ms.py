"""host_ms: host milliseconds a traced frame inside the per-frame set-up
calls, BuiltScene.apply_input and BuiltScene.frame_globals (which makes
ShaderGlobals)."""


def read(rec):
    spans, frames = rec.get("spans", {}), rec.get("frames")
    calls = [spans[n] for n in ("apply_input", "frame_globals") if n in spans]
    if not frames or not calls:
        return None
    return sum(c["host_s"] for c in calls) * 1e3 / frames
