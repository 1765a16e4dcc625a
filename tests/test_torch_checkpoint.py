"""``repro_torch.ckpt``: atomic save/restore round trips of the port's
trees (dicts, per-layer lists, optimizer-state tuples, bf16 leaves), the
reference's layout (``step_<N>/arrays.npz`` keyed by tree path +
``meta.json``), refusals, keep-k and the latest checkpoint, and the
asynchronous writer: a save followed at once by an in-place update writes
the values from before the update. ``restore(shardings=...)`` places each
leaf on a mesh (one gloo rank here; 8 ranks in ``test_torch_elastic.py``)
and ``restore(device=...)`` fills meta ``like`` trees."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from _torch_dist import world1  # noqa: F401
from repro_torch.ckpt import CheckpointManager, restore, save
from repro_torch.ckpt import checkpoint as ckpt_mod


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"embed": torch.randn(8, 4, generator=g), "blocks": [{"w": torch.randn(4, 4, generator=g)}
                                                                 for _ in range(2)],
              "norm": torch.randn(4, generator=g).to(torch.bfloat16)}
    return {"params": params, "opt": (params["embed"] * 2, [{"w": torch.zeros(4, 4)}] * 2)}


def _equal(a, b):
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


def test_round_trip_keeps_structure_dtype_and_bits(tmp_path):
    tree = _tree()
    save(str(tmp_path / "c"), tree, step=3, meta={"pipeline": {"epoch": 1}})
    like = _tree(seed=9)
    got, meta = restore(str(tmp_path / "c"), like)
    assert _equal(got, tree)
    assert meta["step"] == 3 and meta["meta"] == {"pipeline": {"epoch": 1}}
    with np.load(tmp_path / "c" / "arrays.npz") as z:
        assert "['params']/['blocks']/[1]/['w']" in z.files and "['opt']/[0]" in z.files
    assert sorted(os.listdir(tmp_path)) == ["c"] and sorted(os.listdir(tmp_path / "c")) == ["arrays.npz", "meta.json"]
    json.loads((tmp_path / "c" / "meta.json").read_text())


def test_restore_refuses_a_shape_that_disagrees_and_a_missing_leaf(tmp_path):
    save(str(tmp_path / "c"), _tree(), step=1)
    like = _tree()
    like["params"]["embed"] = torch.zeros(9, 4)
    with pytest.raises(ValueError, match="shape"):
        restore(str(tmp_path / "c"), like)
    like = _tree()
    like["params"]["extra"] = torch.zeros(1)
    with pytest.raises(KeyError, match="extra"):
        restore(str(tmp_path / "c"), like)
    with pytest.raises(ValueError, match="shardings for"):
        restore(str(tmp_path / "c"), _tree(), shardings={})


@pytest.mark.parametrize("async_write", [True, False])
def test_manager_keeps_k_and_restores_the_latest(tmp_path, async_write):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=async_write)
    assert mgr.restore_latest(_tree()) == (None, None)
    for step in (1, 2, 3, 4):
        mgr.save(step, _tree(step), meta={"pipeline": {"cursor": step}})
    mgr.wait()
    assert mgr.steps() == [3, 4] and mgr.latest_step() == 4
    got, meta = mgr.restore_latest(_tree())
    assert _equal(got, _tree(4)) and meta["meta"]["pipeline"]["cursor"] == 4
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_async_save_then_in_place_update_writes_the_pre_update_values(tmp_path, monkeypatch):
    """The writer thread is held until the training loop has updated the
    params in place; the checkpoint still holds the values at save time."""
    gate, real = threading.Event(), ckpt_mod._write
    monkeypatch.setattr(ckpt_mod, "_write", lambda *a: gate.wait(10) and real(*a))
    tree = _tree()
    want = {"params": {k: v.clone() if isinstance(v, torch.Tensor) else [{"w": b["w"].clone()} for b in v]
                       for k, v in tree["params"].items()}, "opt": tree["opt"]}
    mgr = CheckpointManager(str(tmp_path), keep=3, async_write=True)
    mgr.save(5, tree)
    with torch.no_grad():  # the optimizer's in-place update
        tree["params"]["embed"].add_(1.0)
        tree["params"]["blocks"][0]["w"].mul_(-3.0)
    gate.set()
    mgr.wait()
    got, _ = mgr.restore_latest(_tree())
    assert _equal(got["params"], want["params"])
    assert not torch.equal(got["params"]["embed"], tree["params"]["embed"])


def test_a_failed_background_write_is_raised_by_wait(tmp_path, monkeypatch):
    def fail(*a):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod, "_write", fail)
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    mgr.save(1, _tree())
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()


def test_restore_onto_shardings_distributes_each_leaf(tmp_path, world1):
    from repro_torch.core.tree import leaves, tree_map
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh

    tree = _tree(5)
    save(str(tmp_path / "c"), tree, step=2)
    mesh = make_host_mesh(1, 1, device="cpu")
    specs = tree_map(lambda x: shd.P("data", *([None] * (x.dim() - 1))), tree)
    got, meta = restore(str(tmp_path / "c"), _tree(), shardings=shd.shardings(specs, mesh))
    assert meta["step"] == 2
    for g, w in zip(leaves(got), leaves(tree)):
        assert shd.is_dtensor(g) and g.device_mesh is mesh and g.dtype == w.dtype
        assert torch.equal(g.full_tensor(), w)
    # a DTensor tree is gathered before a save: saving it as it is raises
    with pytest.raises(ValueError, match="sharding.full"):
        save(str(tmp_path / "d"), got, step=3)
    save(str(tmp_path / "d"), shd.full(got), step=3)
    assert _equal(restore(str(tmp_path / "d"), _tree())[0], tree)


def test_restore_into_a_meta_tree_takes_the_device(tmp_path):
    tree = _tree(6)
    save(str(tmp_path / "c"), tree, step=1)
    from repro_torch.core.tree import tree_map

    got, _ = restore(str(tmp_path / "c"), tree_map(lambda x: x.to("meta"), _tree()), device="cpu")
    assert _equal(got, tree)
