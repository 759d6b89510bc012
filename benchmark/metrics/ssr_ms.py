"""ssr_ms: device milliseconds a traced frame of K8, the screen-space
reflection march: the port's kernel whose name carries
``ssr_march_kernel`` (kernels/csrc/ssr.cu).  Nothing to read where it
did not run (SSR off, or a program without K8)."""

K8 = "ssr_march_kernel"


def read(rec):
    frames = rec.get("frames")
    s = sum(k["s"] for name, k in rec.get("kernels", {}).items()
            if k["port"] and K8 in name)
    return s * 1e3 / frames if frames and s > 0 else None
