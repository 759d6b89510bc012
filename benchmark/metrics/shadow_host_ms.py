"""shadow_host_ms: host milliseconds a traced frame inside the program's
span raster.shadow (graph/frame.raster_stage's sun shadow view: the sun
clip, triangle setup, binning and the K4 launch, shadow.setup and
shadow.resolve), from the program's own totals over the traced frames
(benchmark/passes.py:profiled).  Nothing to read where the build proved
the map empty and the view is elided."""
from benchmark import passes


def read(rec):
    return passes.host_ms(rec, "raster.shadow")
