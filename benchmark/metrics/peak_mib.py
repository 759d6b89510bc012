"""peak_mib: torch.cuda.max_memory_allocated() over the window (its peak
statistics reset when the window opens), in MiB."""


def read(window):
    peak = window.get("peak_bytes")
    return peak / 2 ** 20 if peak else None
