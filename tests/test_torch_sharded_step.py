"""The meshed batched step: ``parallel/mesh.make_batched_render_fn`` with
a (dp = 2, sp = 2) mesh of the CPU device named four times, its inputs
placed by ``shard_inputs``, against the JAX package's meshed
``make_batched_render_fn`` on the (2, 2) mesh of the virtual CPU
devices (the exact oracle plan, at the terrain's frame bounds of
test_torch_parallel.py) and against the port's unmeshed step; and the
checks it makes before it renders.  The row split of one frame is in
tests/test_torch_sharded.py, whose helpers this file reads.

The sky LUT and the smooth SSAO hash are shared between the packages
and between the meshed and the unmeshed step, as in
test_torch_sharded.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import test_torch_parallel as tp
from test_torch_sharded import BOUNDS, cpu_mesh
from soc_real_time_renderer_tpu.graph import frame as jframe
from soc_real_time_renderer_tpu.parallel import mesh as jmesh
from soc_real_time_renderer_tpu_torch.config import RenderConfig
from soc_real_time_renderer_tpu_torch.graph import frame as pframe
from soc_real_time_renderer_tpu_torch.parallel import mesh as pmesh


@pytest.fixture(scope="module")
def meshed_terrain():
    """Two frames of two views of the terrain: the JAX meshed step on the
    (dp = 2, sp = 2) virtual mesh, the port's on a ["cpu"] * 4 (2, 2)
    mesh (its inputs placed by shard_inputs on the first frame), and the
    port's unmeshed step."""
    jb = tp.terrain_jax()
    pb = tp.terrain_port(RenderConfig(**tp.ORACLE))
    positions = tp.POSITIONS["terrain"][:2]
    jm = jmesh.make_mesh(4, dp=2)
    pm = cpu_mesh(4, dp=2)
    jstep = jmesh.make_batched_render_fn(tp.oracle_plan(jb.plan), jm)
    pstep = pmesh.make_batched_render_fn(pb.plan, mesh=pm)
    ustep = pmesh.make_batched_render_fn(pb.plan)
    jh = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs),
        *[jframe.RenderHistory.create(jb.plan.config) for _ in range(2)])
    ph = uh = pmesh.batched_history([pframe.RenderHistory.create(
        pb.plan.config, device="cpu") for _ in range(2)])
    out = []
    jprev = pprev = None
    with pytest.MonkeyPatch.context() as mp:
        tp.shared_inputs(mp, tp.luts_seeded())
        for f in range(2):
            jgs, jmm, jnm = pmesh.view_globals(jb, positions, f, jprev)
            pgs, pmm, pnm = pmesh.view_globals(pb, positions, f, pprev)
            jprev = [g.camera for g in jgs]
            pprev = [g.camera for g in pgs]
            with jm:
                jc, jh = jstep(jb.batch, jmesh.batched_globals(jgs), jh, jmm,
                               jnm)
                jc = np.asarray(jc)
            pgb = pmesh.batched_globals(pgs)
            batch = pb.batch
            if f == 0:
                batch, pgb, ph = pmesh.shard_inputs(pm, pb.batch, pgb, ph)
            pc, ph = pstep(batch, pgb, ph, pmm, pnm)
            uc, uh = ustep(pb.batch, pmesh.batched_globals(pgs), uh, pmm,
                           pnm)
            out.append((jc, jh, pc, ph, uc, uh))
    return pb, out


@pytest.mark.parametrize("frame", [0, 1])
def test_meshed_batched_step_matches_jax_and_unmeshed(meshed_terrain, frame):
    """Per view: the port's (2, 2) meshed step at the terrain's frame
    bounds of the JAX meshed step (exposure within 1e-4), and within
    1e-6 of its unmeshed batched step (colour, history, exposure)."""
    _, frames = meshed_terrain
    jc, jh, pc, ph, uc, uh = frames[frame]
    assert len(pc) == 2 and [b.shape for b in pc[0]] == [(1, 3, 32, 128)] * 2
    got = pmesh.assemble_views(pc, "cpu")
    hist = pmesh.assemble_history(ph, "cpu")
    for i in range(2):
        tp._image_bounds(jc[i], got[i].numpy(), *BOUNDS["terrain"])
        assert abs(float(jh.exposure[i]) - float(hist.exposure[i])) < 1e-4
    worst = max((a.float() - b.float()).abs().max().item() for a, b in (
        (uc, got), (uh.previous_color, hist.previous_color),
        (uh.previous_velocity, hist.previous_velocity),
        (uh.exposure, hist.exposure)))
    assert worst <= 1e-6, worst
    assert (got[0] - got[1]).abs().mean() > 1e-3


def test_meshed_step_refuses_before_rendering(meshed_terrain, monkeypatch):
    """The meshed step checks every view's sun proof first, and a view
    count that dp does not divide."""
    from soc_real_time_renderer_tpu_torch.config import SunInfo
    pb, _ = meshed_terrain
    step = pmesh.make_batched_render_fn(pb.plan, mesh=cpu_mesh(4, dp=2))
    gs, mm, nm = pmesh.view_globals(pb, tp.POSITIONS["terrain"], 0)
    hb = pmesh.batched_history([pframe.RenderHistory.create(
        pb.plan.config, device="cpu") for _ in range(3)])

    def no_render(*a, **k):
        raise AssertionError("rendered before the check")

    monkeypatch.setattr(pframe, "raster_stage", no_render)
    with pytest.raises(ValueError):           # 3 views, dp = 2
        step(pb.batch, pmesh.batched_globals(gs), hb, mm, nm)
    gs = gs[:2]
    gs[1] = dataclasses.replace(gs[1], sun=SunInfo.create(
        angle_direction_deg=(12.0, 0.0, 0.0)))
    hb = pmesh.batched_history([pframe.RenderHistory.create(
        pb.plan.config, device="cpu") for _ in range(2)])
    with pytest.raises(ValueError):
        step(pb.batch, pmesh.batched_globals(gs), hb, mm, nm)
