"""upload_host_ms: host milliseconds a traced frame inside the program's
span globals.upload (BuiltScene.frame_globals: ShaderGlobals.create and
the model and normal matrices, copied to the card one blocking copy a
leaf, with any wait for the card's queue to drain), from the program's
own totals over the traced frames (benchmark/passes.py:profiled)."""
from benchmark import passes


def read(rec):
    return passes.host_ms(rec, "globals.upload")
