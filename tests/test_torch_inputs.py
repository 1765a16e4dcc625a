"""``repro_torch.launch.inputs`` against ``repro.launch.inputs``: for
every architecture and every shape that ``shape_applicable`` admits,
``input_specs`` gives meta tensors of the reference's shapes and dtypes
(tokens, vlm/audio ``prefix_embeds``, and the family's decode cache, each
cache leaf compared at its stacked shape: the port keeps layers in lists
where the reference stacks them). ``concrete_batch`` draws tokens from a
generator on the small configs."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import all_archs as jax_archs
from repro.configs import get_arch as jax_arch
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.base import shape_applicable as jax_shape_applicable
from repro.launch import inputs as jax_inputs
from repro_torch.configs import SHAPES, ShapeConfig, get_arch, shape_applicable
from repro_torch.launch import inputs

PAIRS = [(a, s) for a in sorted(jax_archs()) for s in sorted(SHAPES)]
CELLS = [(a, s) for a, s in PAIRS if shape_applicable(get_arch(a), SHAPES[s])]


def _stacked(tree, stack=()):
    """{path: (stacked shape, dtype name)} of the port's tree; a list of
    layers is one leaf with its length in front, as the reference stacks."""
    if isinstance(tree, dict):
        return {f"{k}/{p}": v for k in sorted(tree) for p, v in _stacked(tree[k], stack).items()}
    if isinstance(tree, list):
        return _stacked(tree[0], stack + (len(tree),))
    if isinstance(tree, int):  # the host-side cache index: the reference's int32 scalar
        return {"": ((), "int32")}
    return {"": (stack + tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


def _jax_leaves(tree):
    if isinstance(tree, dict):
        return {f"{k}/{p}": v for k in sorted(tree) for p, v in _jax_leaves(tree[k]).items()}
    return {"": (tuple(tree.shape), str(tree.dtype))}


def test_shape_applicable_is_the_reference_rule():
    for name, shape_name in PAIRS:
        assert shape_applicable(get_arch(name), SHAPES[shape_name]) == \
            jax_shape_applicable(jax_arch(name), JAX_SHAPES[shape_name]), (name, shape_name)
    assert len(CELLS) == 32  # long_500k only for the two sub-quadratic families


@pytest.mark.parametrize("name,shape_name", CELLS)
def test_input_specs_equal_the_reference(name, shape_name):
    cfg, shape = get_arch(name), SHAPES[shape_name]
    got = inputs.input_specs(cfg, shape)
    want = jax_inputs.input_specs(jax_arch(name), JAX_SHAPES[shape_name])
    assert sorted(got) == sorted(want)
    for k in got:
        if k != "cache":
            assert got[k].device.type == "meta"
    assert _stacked(got) == _jax_leaves(want)


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_concrete_batch_draws_tokens_from_the_generator(kind):
    cfg = get_arch("internvl2-2b").smoke()
    shape = ShapeConfig("small", 24, 4, kind)
    a = inputs.concrete_batch(cfg, shape, torch.Generator().manual_seed(3), device="cpu")
    b = inputs.concrete_batch(cfg, shape, torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(a["tokens"], b["tokens"]) and a["tokens"].dtype == torch.int32
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < cfg.vocab
    if kind == "train":
        assert tuple(a["tokens"].shape) == (4, 24 - cfg.n_prefix)
        assert tuple(a["prefix_embeds"].shape) == (4, cfg.n_prefix, cfg.d_model)
        assert a["prefix_embeds"].dtype == torch.bfloat16 and not a["prefix_embeds"].any()
    else:
        assert tuple(a["tokens"].shape) == (4, 1) and a["cache"]["index"] == 0
        assert tuple(a["cache"]["kv"][0]["k"].shape) == (4, 24, cfg.n_kv_heads, cfg.hd)
        assert np.array_equal(a["cache"]["kv"][0]["k"].float().numpy(), np.zeros((4, 24, cfg.n_kv_heads, cfg.hd)))
