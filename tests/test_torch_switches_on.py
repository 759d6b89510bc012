"""Every RenderConfig switch of the port renders, the second half of
tests/test_torch_switches.py: the switches that are off by default,
each turned on alone, on frame 0 of the reduced ``atrium_passes``
scene.
"""
import pytest

import test_torch_switches as tsw

frame0 = tsw.frame0


@pytest.mark.parametrize("kw", tsw.ON, ids=tsw.variant_id)
def test_every_switch_renders(frame0, kw):
    """render_frame raises NotImplementedError for no RenderConfig
    switch: every boolean off and on, both cloud implementations."""
    tsw.renders(frame0, kw)
