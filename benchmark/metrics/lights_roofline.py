"""lights_roofline: K7's share of its roofline, in percent: the least
time of the frame's local-lights job, max(bytes / HBM_BPS, f32
operations / F32_OPS) (roofline.py's H100 peaks), over K7's device time
a traced frame (lights_ms, the port's ``local_lights_kernel``).

The job is counted from the program's counters (utils/trace): the
(light slot, pixel) pairs the plan binds, ``light_pairs``, the spot
slots' share of them, ``spot_light_pairs``, and the pixels they are
shaded on, ``light_pixels``.  Bytes: albedo, normal and world position
read (36 B a pixel) and the lights' sum written (12 B); the light arrays
(~10 KB a view) are left out.  Operations, counted from K7's source
(kernels/csrc/lights.cu), each clamp bound as one: a point light's pair
is 56 (to the light 3, d2 and its clamp 6, sqrtf 1, the direction 3
divisions, the half vector 3 + its norm 8 + 3 divisions, diffuse 6, the
dot, clamp and acosf 8, exp(-nh^2) and the sum 4, / d2 * intensity 2,
three channels' colour, albedo and sum 9); a spot light's is 66 (the
cone's dot 5, subtraction, division, clamp 2 more).

The bound is a loose lower one, so the share reads low: each IEEE
division, sqrtf, acosf and expf counts as one operation, though each is
a sequence of instructions; F32_OPS is the FMA rate (an FMA counted as
two), though lights.cu, as every kernel of the port, is built with
--fmad=false, so its multiplies and adds issue one at a time; and each
pixel's view direction (14) is left out.  Nothing to read without K7's
time or the counters."""
from benchmark import passes
from benchmark.roofline import F32_OPS, HBM_BPS

BYTES_PIXEL = 48
OPS_POINT_PAIR = 56
OPS_SPOT_PAIR = 66
K7 = "local_lights_kernel"


def read(rec):
    frames = rec.get("frames")
    p = passes.profiled() if frames else None
    counters = p["counters"] if p else {}
    pairs, pixels = counters.get("light_pairs"), counters.get("light_pixels")
    spot = counters.get("spot_light_pairs")
    s = sum(k["s"] for name, k in rec.get("kernels", {}).items()
            if k["port"] and K7 in name)
    if not frames or not pairs or not pixels or spot is None or s <= 0:
        return None
    ops = (pairs - spot) * OPS_POINT_PAIR + spot * OPS_SPOT_PAIR
    bound_s = max(pixels * BYTES_PIXEL / HBM_BPS, ops / F32_OPS)
    return 100.0 * bound_s / s
