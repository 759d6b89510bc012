"""ssr_roofline: K8's share of its roofline, in percent: the bound of
the frame's SSR march job (roofline.frame_jobs' ``ssr_march``: max(bytes
/ 3.35 TB/s, f32 ops / 67 TFLOP/s) over the pixels, rays and probes of
the reference's dense march of the first sampled frame) over K8's device
time a traced frame (ssr_ms, the port's ``ssr_march_kernel``).  At
1920x1088 the job is bound by its bytes, 44 a pixel, the same every
frame.  Nothing to read without either."""

K8 = "ssr_march_kernel"


def read(rec):
    job, frames = (rec.get("jobs_ms") or {}).get("ssr_march"), \
        rec.get("frames")
    s = sum(k["s"] for name, k in rec.get("kernels", {}).items()
            if k["port"] and K8 in name)
    if not job or not frames or s <= 0:
        return None
    return 100.0 * job / (s * 1e3 / frames)
