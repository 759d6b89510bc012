"""shadow_resolve_ms: device milliseconds a traced frame of K4, the
shadow view's depth resolve: the port's kernel whose name carries
``resolve_body<false`` (kernels/csrc/resolve.cu, the instantiation
without the id row; K1 is ``resolve_body<true``)."""

K4 = "resolve_body<false"


def read(rec):
    frames = rec.get("frames")
    s = sum(k["s"] for name, k in rec.get("kernels", {}).items()
            if k["port"] and K4 in name)
    return s * 1e3 / frames if frames and s > 0 else None
