"""Parity of the port's TAA (K3's plain version + the 3x3 resolve) with
the JAX package: against the exact ``taa(impl="xla")`` and, on pixels
the TPU kernel keeps in its window, against ``taa(impl="pallas")`` in
interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soc_real_time_renderer_tpu.ops import taa as jtaa
from soc_real_time_renderer_tpu.ops import taa_pallas
from soc_real_time_renderer_tpu_torch import convert
from soc_real_time_renderer_tpu_torch.ops import taa as ptaa

H, W = 64, 256


def _data(seed, vel_px, frame_counter):
    rng = np.random.default_rng(seed)
    color = (rng.random((3, H, W), dtype=np.float32) ** 2 * 3.0)
    depth = rng.random((H, W), dtype=np.float32)
    vel = ((rng.random((2, H, W), dtype=np.float32) - 0.5)
           * (2.0 * vel_px / np.array([W, H], np.float32)[:, None, None]))
    pc = jnp.asarray(rng.random((3, H, W), dtype=np.float32) * 3.0
                     ).astype(jnp.bfloat16)
    pv = jnp.asarray(vel * 0.9).astype(jnp.bfloat16)
    return color, depth, vel.astype(np.float32), pc, pv, np.int32(
        frame_counter)


def _port(args, impl=None):
    color, depth, vel, pc, pv, fc = args
    return ptaa.taa(torch.from_numpy(color), torch.from_numpy(depth),
                    torch.from_numpy(vel), convert.to_tensor(pc),
                    convert.to_tensor(pv), torch.tensor(fc),
                    impl=impl).numpy()


@pytest.mark.parametrize("seed,vel_px,fc", [(1, 2.0, 0), (2, 2.0, 7),
                                            (3, 40.0, 3)])
def test_taa_matches_exact_xla(seed, vel_px, fc):
    """max abs < 1e-5 (40 px of motion reaches the screen edges and the
    off-screen path)."""
    args = _data(seed, vel_px, fc)
    want = np.asarray(jax.jit(
        lambda *a: jtaa.taa(*a, impl="xla"))(*args))
    got = _port(args)
    assert got.shape == want.shape == (3, H, W)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_taa_matches_pallas_kernel_in_window():
    """The TPU kernel blends with bf16 one-hot weights and flags taps
    that leave its window (oow): on oow == 0 pixels the bound is the
    reference's own chip check, max < 0.02 (verify_chip.py:192)."""
    args = _data(4, 2.0, 5)
    color, depth, vel, pc, pv, fc = args
    want = np.asarray(jtaa.taa(*args, impl="pallas", interpret=True))
    packed = jnp.concatenate([pc, pv], axis=0)
    _, oow = taa_pallas.reproject_history_pallas(packed, jnp.asarray(vel),
                                                 interpret=True)
    keep = np.asarray(oow) == 0
    assert keep.mean() > 0.9
    got = _port(args)
    assert np.abs(got - want)[:, keep].max() < 0.02


def test_reproject_history_plain_and_dispatch():
    """K3's plain version equals the JAX bilinear fetch of the packed
    bf16 history; impl="cuda" on CPU tensors raises."""
    from soc_real_time_renderer_tpu.ops import sampling as jsampling
    rng = np.random.default_rng(5)
    hist = jnp.asarray(rng.random((5, H, W), dtype=np.float32)
                       ).astype(jnp.bfloat16)
    vel = ((rng.random((2, H, W), dtype=np.float32) - 0.5) * 0.05)
    uv = jsampling.grid_uv(H, W)
    want = np.asarray(jsampling.sample_screen(
        hist, jnp.stack([uv[0] - vel[0], uv[1] - vel[1]])))
    th, tv = convert.to_tensor(hist), torch.from_numpy(vel)
    got = ptaa.reproject_history(th, tv).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        ptaa.reproject_history(th, tv, impl="cuda")


F = np.float32


def _nan_min(a, b):      # torch.minimum: NaN if either is NaN
    return a if (np.isnan(a) or a < b) else b


def _nan_max(a, b):
    return a if (np.isnan(a) or a > b) else b


def _nan_clamp(v, lo, hi):
    return v if np.isnan(v) else min(max(v, F(lo)), F(hi))


def _oracle(color, depth, vel, pc, pv, fc):
    """The resolve pixel by pixel in float32 scalars, as the shader
    writes it (temporal_antialiasing.inl:120-199): the 3x3 loop (y: 1..-1,
    x: 1..-1) with clamp-to-edge texels, blurred colour, AABB, the
    neighbors[5] texel and the closest depth ("<=": the latest minimum
    wins); the velocity there; the bilinear clamp-to-edge history at
    uv - velocity; blend 0.1 (the frame counter below it, 1 off-screen);
    the AABB clamp and the disocclusion lerp to the blurred colour.
    Returns (resolved, {"off": off-screen pixels, "tie": pixels whose
    closest depth was a tie})."""
    _, H, W = color.shape
    out = np.empty((3, H, W), np.float32)
    seen = {"off": 0, "tie": 0}

    def at(img, x, y):
        return img[..., min(max(y, 0), H - 1), min(max(x, 0), W - 1)]

    def bilinear(img, u, v):
        xf, yf = u * F(W) - F(0.5), v * F(H) - F(0.5)
        x0 = 0 if np.isnan(xf) else min(max(int(np.floor(xf)), 0), W - 1)
        y0 = 0 if np.isnan(yf) else min(max(int(np.floor(yf)), 0), H - 1)
        x1, y1 = min(x0 + 1, W - 1), min(y0 + 1, H - 1)
        fx = _nan_clamp(xf - F(x0), 0, 1)
        fy = _nan_clamp(yf - F(y0), 0, 1)
        top = img[:, y0, x0] * (F(1) - fx) + img[:, y0, x1] * fx
        bot = img[:, y1, x0] * (F(1) - fx) + img[:, y1, x1] * fx
        return top * (F(1) - fy) + bot * fy

    for y in range(H):
        for x in range(W):
            blurred = np.zeros(3, np.float32)
            lo = [F(1e6)] * 3
            hi = [F(-1e6)] * 3
            closest, best, ties = F(1), (0, 0), 0
            for dy in (1, 0, -1):
                for dx in (1, 0, -1):
                    index = (dy + 1) * 3 + (dx + 1)
                    c, d = at(color, x + dx, y + dy), at(depth, x + dx, y + dy)
                    if d <= closest:
                        ties += d == closest
                        best = (dx, dy)
                    closest = _nan_min(closest, d)
                    lo = [_nan_min(a, b) for a, b in zip(lo, c)]
                    hi = [_nan_max(a, b) for a, b in zip(hi, c)]
                    blurred = blurred + F(ptaa.GAUSS[index]) * c
                    if index == 5:
                        center = c
            v = at(vel, x + best[0], y + best[1])
            u = (F(x) + F(0.5)) / F(W) - v[0]
            w = (F(y) + F(0.5)) / F(H) - v[1]
            accum = min(F(fc), F(0.1))
            if u < 0 or w < 0 or u > 1 or w > 1:
                accum = F(1)
                seen["off"] += 1
            seen["tie"] += ties > 0 and closest == at(depth, x + best[0],
                                                      y + best[1])
            hist, hvel = bilinear(pc, u, w), bilinear(pv, u, w)
            acc = np.array([_nan_min(_nan_max(h, a), b)
                            for h, a, b in zip(hist, lo, hi)], np.float32)
            res = center * accum + acc * (F(1) - accum)
            dv = hvel - v
            vel_len = np.sqrt(dv[0] * dv[0] + dv[1] * dv[1])
            disocc = _nan_clamp((vel_len - F(0.001)) * F(10), 0, 1)
            out[:, y, x] = res + (blurred - res) * disocc
    return out, seen


@pytest.mark.parametrize("fc,nan", [(0, False), (7, False), (7, True)],
                         ids=["first_frame", "blend", "nan_texel"])
def test_plain_resolve_matches_per_pixel_oracle(fc, nan):
    """taa(impl="plain") against the scalar per-pixel loop at 8x6, max
    abs 0 and NaN at the same pixels: every edge and corner pixel, a tie
    in the closest depth, velocities that throw uv off the screen (blend
    1), history velocities that disocclude, frame counter 0 (blend 0),
    and a NaN colour texel, whose 3x3 turns NaN."""
    h, w = 6, 8
    rng = np.random.default_rng(11 + fc + nan)
    color = (rng.random((3, h, w)) * 3).astype(np.float32)
    depth = rng.uniform(0.2, 1.0, (h, w)).astype(np.float32)
    depth[2, 3] = depth[2, 5] = 0.05       # pixel (4, 2) sees a tie
    depth[0, 0] = 1.0
    vel = ((rng.random((2, h, w)) - 0.5) * 0.3).astype(np.float32)
    vel[:, 4, 1] = (2.0, -1.5)             # far off the screen
    vel[:, 0, 7] = (-0.2, 0.0)
    if nan:
        color[1, 3, 6] = np.nan
    pc = torch.from_numpy((rng.random((3, h, w)) * 3).astype(np.float32)
                          ).to(torch.bfloat16)
    pv = torch.from_numpy(vel * rng.choice([0.9, 1.0, -3.0], (2, h, w))
                          .astype(np.float32)).to(torch.bfloat16)
    want, seen = _oracle(color, depth, vel, pc.float().numpy(),
                         pv.float().numpy(), fc)
    got = ptaa.taa(torch.from_numpy(color), torch.from_numpy(depth),
                   torch.from_numpy(vel), pc, pv,
                   torch.tensor(fc, dtype=torch.int32), impl="plain")
    np.testing.assert_array_equal(got.numpy(), want)
    assert seen["off"] >= 1 and seen["tie"] >= 1
    nans = np.isnan(want).any(0)
    assert nans.sum() == (9 if nan else 0)


def test_taa_dispatch_and_shapes():
    """impl="cuda" on CPU tensors raises, as does a history of another
    size or a band whose rows leave the screen."""
    h, w = 6, 8
    args = [torch.zeros(3, h, w), torch.ones(h, w), torch.zeros(2, h, w),
            torch.zeros(3, h, w, dtype=torch.bfloat16),
            torch.zeros(2, h, w, dtype=torch.bfloat16),
            torch.tensor(3, dtype=torch.int32)]
    assert ptaa.taa(*args).shape == (3, h, w)
    with pytest.raises(ValueError):
        ptaa.taa(*args, impl="cuda")
    with pytest.raises(ValueError):
        ptaa.taa(*args[:3], args[3][:, :4], *args[4:])
    with pytest.raises(ValueError):
        ptaa._resolve(*args, row0=2, crop=1)
