"""The frozen copy of the asset generator writes the tree the port's
tools/synth_assets.py writes today, byte for byte (at small sizes)."""
import os

from benchmark import assets

SMALL = dict(rings=6, segments=9, helmet_map=32, sponza_map=16, noise=16,
             workers=2)


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_tree_is_byte_identical_to_the_ports(tmp_path):
    from soc_real_time_renderer_tpu_torch.tools import synth_assets
    synth_assets.write_asset_tree(str(tmp_path / "port"), **SMALL)
    assets.write_asset_tree(str(tmp_path / "copy"), **SMALL)
    port, copy = _files(tmp_path / "port"), _files(tmp_path / "copy")
    assert port.keys() == copy.keys() and len(port) > 10
    assert port == copy


def test_ensure_writes_once_and_starts_over_after_a_cut(tmp_path, monkeypatch):
    root = str(tmp_path / "tree")
    calls = []
    real = assets.write_asset_tree

    def small(r, **kw):
        calls.append(r)
        return real(r, **SMALL)

    monkeypatch.setattr(assets, "write_asset_tree", small)
    os.makedirs(root + ".partial")          # a run cut off while writing
    assert assets.ensure(root) is True
    assert assets.ensure(root) is False
    assert len(calls) == 1 and assets.is_synthetic(root)
    assert not os.path.exists(root + ".partial")
