"""lights_ms: device milliseconds a traced frame of K7, composition's
point and spot lights: the port's kernel whose name carries
``local_lights_kernel`` (kernels/csrc/lights.cu).  Nothing to read where
it did not run (a scene with no light, or a program without K7)."""

K7 = "local_lights_kernel"


def read(rec):
    frames = rec.get("frames")
    s = sum(k["s"] for name, k in rec.get("kernels", {}).items()
            if k["port"] and K7 in name)
    return s * 1e3 / frames if frames and s > 0 else None
