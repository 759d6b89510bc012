"""shadow_roofline: K4's share of its roofline, in percent: the bound of
the shadow view's depth-resolve job (roofline.frame_jobs'
``resolve_depth``: max(bytes / 3.35 TB/s, f32 ops / 67 TFLOP/s) over the
reference's covered texels of the frame) over K4's device time a traced
frame (shadow_resolve_ms, the port's ``resolve_body<false`` kernel).
Nothing to read without either."""

K4 = "resolve_body<false"


def read(rec):
    job, frames = (rec.get("jobs_ms") or {}).get("resolve_depth"), \
        rec.get("frames")
    s = sum(k["s"] for name, k in rec.get("kernels", {}).items()
            if k["port"] and K4 in name)
    if not job or not frames or s <= 0:
        return None
    return 100.0 * job / (s * 1e3 / frames)
