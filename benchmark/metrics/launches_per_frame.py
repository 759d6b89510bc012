"""launches_per_frame: CUDA kernels a traced frame on the card (the
profiler's device events, copies and fills left out)."""


def read(rec):
    kernels, frames = rec.get("kernels", {}), rec.get("frames")
    n = sum(k["n"] for k in kernels.values() if not k["copy"])
    return n / frames if frames and n else None
