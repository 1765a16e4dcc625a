"""``repro_torch.dist.sharding`` against ``repro.dist.sharding``: the
partition specs of all ten architectures' param trees, of the four
shapes' batches and of the decode shapes' caches, on the meshes (4, 2),
(2, 2, 2), (16, 16) and (2, 16, 16) as abstract shapes, spec for spec.
The reference's trees come from ``eval_shape``, the port's from the meta
device. The reference stacks layers on leading axes where the port keeps
lists, so the port's stacked specs (``stacked_param_specs``,
``stacked_cache_specs``) are held to the reference's, and its per-layer
specs to those without the stack dims. Also: ``constrain`` is the
identity with no mesh, the placements follow the spec, and the LM meshes
(``launch.mesh``)."""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JaxP

from _torch_dist import world1  # noqa: F401
from repro.configs import all_archs as jax_archs
from repro.configs import get_arch as jax_arch
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.dist import sharding as jax_shd
from repro.models import lm as jax_lm
from repro_torch.configs import SHAPES, get_arch, shape_applicable
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import lm

MESHES = {"4x2": {"data": 4, "model": 2}, "2x2x2": {"pod": 2, "data": 2, "model": 2},
          "16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16}}
ARCHS = sorted(jax_archs())


class _JaxShape:
    """What the reference's policy reads of a mesh: ``shape``."""

    def __init__(self, shape):
        self.shape = shape


def _jax_tuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, JaxP))


def _tuples(tree):
    return shd.map_specs(tuple, tree)


@functools.lru_cache(maxsize=None)
def _params(name):
    jabs = jax.eval_shape(functools.partial(jax_lm.init_lm, jax_arch(name)), jax.random.PRNGKey(0))
    return jabs, lm.init_lm(get_arch(name), torch.Generator(), "meta")


@functools.lru_cache(maxsize=None)
def _cache(name, shape_name):
    shape = SHAPES[shape_name]
    jc = jax.eval_shape(lambda: jax_lm.init_cache(jax_arch(name), shape.global_batch, shape.seq_len))
    return jc, lm.init_cache(get_arch(name), shape.global_batch, shape.seq_len, device="meta")


def _drop_stack(stacked, per_layer, depth=0):
    """Every per-layer spec is its stacked spec without the ``depth``
    leading (list) dims."""
    if isinstance(per_layer, dict):
        for k in per_layer:
            _drop_stack(stacked[k], per_layer[k], depth)
    elif isinstance(per_layer, list):
        for item in per_layer:
            _drop_stack(stacked, item, depth + 1)
    elif len(stacked) == 0:  # a leaf below 2 stacked dims, or the cache's index
        assert tuple(per_layer) == ()
    else:
        assert tuple(per_layer) == tuple(stacked)[depth:], (stacked, per_layer)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", ARCHS)
def test_param_specs_equal_the_reference(name, mesh_name):
    jabs, pabs = _params(name)
    m = MESHES[mesh_name]
    want = _jax_tuples(jax_shd.param_specs(jabs, jax_arch(name), _JaxShape(m)))
    stacked = shd.stacked_param_specs(pabs, get_arch(name), mesh_mod.AbstractMesh(m))
    assert _tuples(stacked) == want
    _drop_stack(stacked, shd.param_specs(pabs, get_arch(name), mesh_mod.AbstractMesh(m)))


@pytest.mark.parametrize("shape_name", sorted(SHAPES))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", ARCHS)
def test_batch_and_cache_specs_equal_the_reference(name, mesh_name, shape_name):
    m, shape, jshape = MESHES[mesh_name], SHAPES[shape_name], JAX_SHAPES[shape_name]
    assert (shape.kind, shape.global_batch, shape.seq_len) == (jshape.kind, jshape.global_batch, jshape.seq_len)
    jcfg, cfg, amesh = jax_arch(name), get_arch(name), mesh_mod.AbstractMesh(m)
    assert _tuples(shd.batch_specs(cfg, shape.kind, amesh, shape.global_batch)) == \
        _jax_tuples(jax_shd.batch_specs(jcfg, shape.kind, _JaxShape(m), shape.global_batch))
    if shape.kind != "decode" or not shape_applicable(cfg, shape):
        return
    jc, pc = _cache(name, shape_name)
    want = _jax_tuples(jax_shd.cache_specs(jcfg, _JaxShape(m), shape.global_batch, jc))
    stacked = shd.stacked_cache_specs(cfg, amesh, shape.global_batch, pc)
    assert _tuples(stacked) == want
    _drop_stack(stacked, shd.cache_specs(cfg, amesh, shape.global_batch, pc))


def test_constrain_is_the_identity_without_a_mesh():
    x = torch.randn(2, 8, 16)
    assert shd.activation_ctx() == (None, False)
    assert shd.constrain(x, "resid") is x and shd.constrain(x, "logits") is x
    # a plain tensor under an installed mesh, and a tensor below 3 dims, pass as they are
    y = x[0]
    shd.set_activation_ctx(mesh_mod.make_production_mesh())
    try:
        assert shd.constrain(x, "logits") is x and shd.constrain(y, "resid") is y
    finally:
        shd.set_activation_ctx(None)


def test_activation_specs_follow_the_reference_rule():
    m = mesh_mod.make_production_mesh(multi_pod=True)
    assert tuple(shd.activation_spec((64, 4096, 3072), "resid", m)) == (("pod", "data"), None, None)
    assert tuple(shd.activation_spec((64, 4096, 3072), "resid", m, seq_shard=True)) == \
        (("pod", "data"), "model", None)
    assert tuple(shd.activation_spec((64, 4096, 128256), "logits", m)) == (("pod", "data"), None, "model")
    assert tuple(shd.activation_spec((3, 4096, 100), "logits", mesh_mod.make_production_mesh())) == \
        (None, None, None)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    m = mesh_mod.AbstractMesh(MESHES["2x2x2"])
    assert shd.placements(shd.P(("pod", "data"), None, "model"), m) == (Shard(0), Shard(0), Shard(2))
    assert shd.placements(shd.P(None, "data"), m) == (Replicate(), Shard(1), Replicate())
    assert shd.placements(shd.P(), m) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        shd.placements(shd.P(("data", "pod")), m)
    meta = shd.abstract_with_sharding({"w": torch.empty(8, 4, device="meta")}, {"w": shd.P("data", "model")}, m)
    assert meta["w"].device.type == "meta" and tuple(meta["w"].spec) == ("data", "model")
    assert meta["w"].placements == (Replicate(), Shard(0), Shard(1))


def test_production_meshes_are_the_reference_shapes():
    assert mesh_mod.make_production_mesh().shape == {"data": 16, "model": 16}
    multi = mesh_mod.make_production_mesh(multi_pod=True)
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and multi.axis_names == ("pod", "data", "model")
    assert multi.size == 512


def test_host_mesh_needs_a_group_and_the_right_world_size(world1):
    m = mesh_mod.make_host_mesh(1, 1, device="cpu")
    assert shd.mesh_shape(m) == {"data": 1, "model": 1} and m.device_type == "cpu"
    with pytest.raises(ValueError, match=r"\(2, 4\).*8 ranks.*has 1"):
        mesh_mod.make_host_mesh(2, 4, device="cpu")


def test_host_mesh_without_a_group_raises():
    with pytest.raises(RuntimeError, match="init_world"):
        mesh_mod.make_host_mesh(1, 1, device="cpu")


def test_distribute_and_full_round_trip_on_one_rank(world1):
    m = mesh_mod.make_host_mesh(1, 1, device="cpu")
    tree = {"a": torch.arange(12.0).reshape(3, 4), "b": [torch.ones(5)]}
    specs = {"a": shd.P("data", "model"), "b": [shd.P()]}
    d = shd.distribute(tree, shd.shardings(specs, m))
    assert shd.is_dtensor(d["a"]) and shd.is_dtensor(d["b"][0])
    back = shd.full(d)
    assert torch.equal(back["a"], tree["a"]) and torch.equal(back["b"][0], tree["b"][0])
    assert not shd.is_dtensor(back["a"]) and np.isfinite(back["a"].numpy()).all()
