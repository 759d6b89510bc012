"""Parity of the port's SSAO (preamble + K2 tap loop, plain PyTorch on
the CPU) with the JAX package: against the exact XLA tail
``ssao_generate`` and, after the blur, against the Pallas kernel in
interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soc_real_time_renderer_tpu import config as jcfg
from soc_real_time_renderer_tpu.camera import Camera3D, camera_matrices
from soc_real_time_renderer_tpu.ops import ssao as jssao
from soc_real_time_renderer_tpu_torch import convert
from soc_real_time_renderer_tpu_torch.ops import ssao as pssao

H, W = 128, 256


def _scene(seed):
    """Blocky depth field with occlusion edges in the far-skewed range a
    perspective projection gives, random upward-facing normals."""
    rng = np.random.default_rng(seed)
    base = rng.random((8, 16)).astype(np.float32)
    d = np.kron(base, np.ones((16, 16), np.float32))
    depth = np.clip(d * 0.15 + 0.82, 0.6, 0.995).astype(np.float32)
    n = rng.normal(size=(3, H, W)).astype(np.float32)
    n[2] = np.abs(n[2]) + 1.5
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    cam = Camera3D()
    cam.resize(W, H)
    g = jcfg.ShaderGlobals.create(
        camera=camera_matrices(cam, [0, 0, 0], 1, W, H))
    return depth, n, g


@pytest.fixture(scope="module", params=[7, 11])
def scene(request):
    depth, n, g = _scene(request.param)
    ref = np.asarray(jax.jit(jssao.ssao_generate)(depth, n, g))
    return depth, n, g, ref


def smooth_rand_jax(cu, cv):
    return 0.5 + 0.5 * jnp.sin(cu * 0.7 + cv * 1.3)


def smooth_rand_torch(cu, cv):
    return 0.5 + 0.5 * torch.sin(cu * 0.7 + cv * 1.3)


def test_ssao_matches_exact_xla_tail(scene, monkeypatch):
    """Mean abs < 1e-4; max <= one tap (1/26): a single tap's hit test
    may flip where the occluder depth ties the sample depth.

    Both packages get the same smooth noise hash here: the reference's
    rand() is fract(sin(.) * 43758.5453), which turns a 1-ulp difference
    between XLA's and PyTorch's sin into ~3e-3 of noise and rotates the
    tangent frame of whole noise cells (held separately below)."""
    depth, n, g, _ = scene
    monkeypatch.setattr(jssao, "_rand", smooth_rand_jax)
    monkeypatch.setattr(pssao, "_rand", smooth_rand_torch)
    # a new function object: jit's cache must not serve the trace made
    # with the real hash
    ref = np.asarray(jax.jit(
        lambda d, n_, g_: jssao.ssao_generate(d, n_, g_))(depth, n, g))
    got = pssao.ssao_generate(torch.from_numpy(depth), torch.from_numpy(n),
                              convert.globals_from_numpy(g)).numpy()
    assert got.shape == ref.shape == (H // 2, W // 2)
    diff = np.abs(got - ref)
    assert diff.mean() < 1e-4, diff.mean()
    assert diff.max() <= 1.0 / 26 + 1e-5, diff.max()


def test_ssao_real_hash_within_noise_cells(scene):
    """The reference hash: whole noise cells may take a different
    tangent frame (see above); held at mean abs < 5e-3, one tap-flip
    per ~8 pixels."""
    depth, n, g, ref = scene
    got = pssao.ssao_generate(torch.from_numpy(depth), torch.from_numpy(n),
                              convert.globals_from_numpy(g)).numpy()
    assert np.abs(got - ref).mean() < 5e-3


def test_ssao_taps_exact_on_the_same_preamble(scene):
    """K2's loop itself (the plain version of the CUDA kernel) on the
    JAX package's own preamble planes: float-exact up to summation
    order."""
    depth, n, g, ref = scene
    planes = np.concatenate(
        [np.asarray(a) for a in jax.jit(jssao._preamble)(depth, n, g)])
    pg = convert.globals_from_numpy(g)
    got = pssao.ssao_taps_plain(
        torch.from_numpy(planes), torch.from_numpy(depth),
        pg.camera.projection, pg.camera.inv_projection, pg.ssao_radius,
        pg.ssao_bias, pssao.kernel_vectors(26, "cpu")).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_ssao_blurred_matches_pallas_kernel(scene):
    """The TPU kernel approximates (half-res occluders, windowed taps):
    the bound is the reference's own chip check (verify_chip.py:173)."""
    depth, n, g, _ = scene
    ref = np.asarray(jssao.ssao_blur(jssao.ssao_generate_pallas(
        jnp.asarray(depth), jnp.asarray(n), g, interpret=True,
        window_rows=32, window_lanes=128)))
    got = pssao.ssao_blur(pssao.ssao_generate(
        torch.from_numpy(depth), torch.from_numpy(n),
        convert.globals_from_numpy(g))).numpy()
    assert np.abs(got - ref).mean() < 0.01


def test_ssao_blur_matches(scene):
    depth, n, g, ref = scene
    got = pssao.ssao_blur(torch.from_numpy(ref)).numpy()
    want = np.asarray(jssao.ssao_blur(jnp.asarray(ref)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_ssao_taps_plain_is_the_kernel_contract():
    """The dispatch takes the plain version for CPU tensors and refuses
    to run the CUDA kernel on them."""
    depth, n, g = _scene(3)
    pg = convert.globals_from_numpy(g)
    d, nn = torch.from_numpy(depth), torch.from_numpy(n)
    a = pssao.ssao_generate(d, nn, pg)
    b = pssao.ssao_generate(d, nn, pg, impl="plain")
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        pssao.ssao_generate(d, nn, pg, impl="cuda")


@pytest.mark.parametrize("kernel_size", [1, 8, 26])
def test_ssao_generate_kernel_sizes(kernel_size, monkeypatch):
    """1, 8 and 26 taps through `ssao_generate` against the JAX exact
    tail with the same smooth hash: mean abs < 1e-4, max <= one tap
    (1 / kernel_size), as for the 26-tap case above."""
    depth, n, g = _scene(7)
    monkeypatch.setattr(jssao, "_rand", smooth_rand_jax)
    monkeypatch.setattr(pssao, "_rand", smooth_rand_torch)
    ref = np.asarray(jax.jit(lambda d, n_, g_: jssao.ssao_generate(
        d, n_, g_, kernel_size))(depth, n, g))
    got = pssao.ssao_generate(torch.from_numpy(depth), torch.from_numpy(n),
                              convert.globals_from_numpy(g),
                              kernel_size).numpy()
    diff = np.abs(got - ref)
    assert diff.mean() < 1e-4, diff.mean()
    assert diff.max() <= 1.0 / kernel_size + 1e-5, diff.max()
    assert got.min() < 1.0, "some pixel is occluded"


@pytest.mark.parametrize("what", ["kernel_vectors", "noise_constant"])
def test_ssao_cached_constants(what):
    """The hemisphere table and the preamble's W * 4.2 constant are made
    once per (values, device) (sampling.constant): equal to a freshly
    made tensor bit for bit, the same object on the next call, and on
    the device asked for."""
    if what == "kernel_vectors":
        cached = pssao.kernel_vectors(8, "cpu")
        fresh = torch.tensor(pssao.KERNEL[:8], dtype=torch.float32)
        again = pssao.kernel_vectors(8, torch.device("cpu"))
        meta = pssao.kernel_vectors(8, "meta")
        assert pssao.kernel_vectors(26, "cpu").shape == (26, 3)
    else:
        from soc_real_time_renderer_tpu_torch.ops import sampling
        cached = sampling.constant(256 * 4.2, "cpu")
        fresh = torch.tensor(256 * 4.2, dtype=torch.float32)
        again = sampling.constant(256 * 4.2, torch.device("cpu"))
        meta = sampling.constant(256 * 4.2, "meta")
    assert cached.dtype == torch.float32 and cached.shape == fresh.shape
    assert torch.equal(cached, fresh) and again is cached
    assert meta.device.type == "meta" and meta.shape == cached.shape


@pytest.mark.parametrize("k", [0, 65])
def test_ssao_refuses_tap_counts(k):
    """The tap loop takes 1 to 64 kernel vectors (K2's table), the
    hemisphere table 1 to 26: anything else is refused on every
    device, before the dispatch."""
    depth, n, g = _scene(3)
    pg = convert.globals_from_numpy(g)
    planes = torch.zeros(12, H // 2, W // 2)
    with pytest.raises(ValueError, match="1 <= k <= 64"):
        pssao.ssao_taps(planes, torch.from_numpy(depth),
                        pg.camera.projection, pg.camera.inv_projection,
                        pg.ssao_radius, pg.ssao_bias, torch.zeros(k, 3))
    with pytest.raises(ValueError, match="kernel_size"):
        pssao.ssao_generate(torch.from_numpy(depth), torch.from_numpy(n), pg,
                            kernel_size=k)
