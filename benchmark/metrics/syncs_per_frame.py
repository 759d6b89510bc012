"""syncs_per_frame: calls a traced frame that made the host wait for the
card, counted under torch.cuda.set_sync_debug_mode("warn") by call site
(0 is a reading: no call waited)."""


def read(rec):
    frames = rec.get("frames")
    if not frames:
        return None
    return sum(rec.get("syncs", {}).values()) / frames
