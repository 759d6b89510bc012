"""kernels_roofline: the sum of the frame's hand-kernel jobs' bounds
(roofline.frame_jobs: max(bytes / 3.35 TB/s, f32 ops / 67 TFLOP/s) each)
over the device time a traced frame of the kernels built from the port's
own sources, in percent.  Nothing to read without either."""


def read(rec):
    jobs, frames = rec.get("jobs_ms") or {}, rec.get("frames")
    port_s = sum(k["s"] for k in rec.get("kernels", {}).values()
                 if k["port"])
    if not jobs or not frames or port_s <= 0:
        return None
    return 100.0 * sum(jobs.values()) / (port_s * 1e3 / frames)
