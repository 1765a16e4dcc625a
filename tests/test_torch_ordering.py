"""The port's ordering policies, permutation sources, stop rules and
synthetic table, against repro.core where the reference defines the
result."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import convergence as ref_conv, ordering as ref_ordering
from repro.data import synthetic as ref_synthetic
from repro_torch.core import convergence, draws, ordering, tracecount
from repro_torch.data import synthetic

torch.set_num_threads(1)


def _draws(values):
    it = iter(values)
    return lambda: next(it)


def _table(n=12):
    return {"x": torch.arange(2 * n, dtype=torch.float32).reshape(n, 2), "y": torch.arange(n, dtype=torch.float32)}


def test_clustered_returns_stored_order_and_draws_nothing():
    data = _table()
    assert ordering.Clustered().order(data, 12, 1, _draws([])) is data


def test_shuffle_always_draws_every_epoch():
    data = _table()
    perms = [torch.randperm(12, generator=torch.Generator().manual_seed(s)) for s in range(3)]
    pol = ordering.ShuffleAlways()
    draw = _draws(perms)
    for p in perms:
        out = pol.order(data, 12, 1, draw)
        assert torch.equal(out["y"], data["y"][p]) and torch.equal(out["x"], data["x"][p])


def test_shuffle_once_is_fixed_and_invalidates_on_new_data():
    data, other = _table(), _table()
    perms = [torch.randperm(12, generator=torch.Generator().manual_seed(s)) for s in range(2)]
    pol = ordering.ShuffleOnce()
    draw = _draws(perms)
    first = pol.order(data, 12, 1, draw)
    assert pol.order(data, 12, 2, draw) is first
    assert torch.equal(first["y"], data["y"][perms[0]])
    moved = pol.order(other, 12, 3, draw)
    assert torch.equal(moved["y"], other["y"][perms[1]])


def test_torch_permutations_are_seeded_streams():
    """The default draw source: one seeded generator a run, so two runs
    with one seed draw the same permutations and scheme draws in turn."""
    src = draws.TorchDraws()
    a, b = src.stream(7, 50, torch.device("cpu")), src.stream(7, 50, torch.device("cpu"))
    p1, p2 = a.permutation(), a.permutation()
    assert torch.equal(p1, b.permutation()) and not torch.equal(p1, p2)
    assert torch.equal(torch.sort(p1).values, torch.arange(50))
    assert torch.equal(b.permutation(), p2)
    assert torch.equal(a.epoch().reservoir(), b.epoch().reservoir())


def test_cluster_by_label_matches_reference():
    y = np.array([-1, 1, 1, -1, 1, -1, -1, 1], np.float32)
    x = np.arange(16, dtype=np.float32).reshape(8, 2)
    want = ref_ordering.cluster_by_label({"x": jnp.asarray(x), "y": jnp.asarray(y)}, jnp.asarray(y))
    got = ordering.cluster_by_label({"x": torch.from_numpy(x), "y": torch.from_numpy(y)}, torch.from_numpy(y))
    for k in ("x", "y"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_catx_dataset_matches_reference():
    want, got = ref_ordering.make_catx_dataset(5), ordering.make_catx_dataset(5, device="cpu")
    for k in ("x", "y"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert ordering.catx_closed_form(0.3, 0.05, 200) == ref_ordering.catx_closed_form(0.3, 0.05, 200)


def test_catx_dataset_without_a_card_raises_instead_of_running_on_cpu():
    """Like Engine(), make_catx_dataset builds on the card unless asked for
    the CPU, so its table and an Engine() on the card agree."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: make_catx_dataset(5) builds there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ordering.make_catx_dataset(5)
    assert ordering.make_catx_dataset(5, device="cpu")["x"].device == torch.device("cpu")


@pytest.mark.parametrize("losses,epoch", [([], 1), ([3.0], 1), ([3.0, 2.999], 2), ([3.0, 2.0], 2), ([0.0, 0.0], 2)])
def test_stop_rules_match_reference(losses, epoch):
    for name, args in (("FixedEpochs", (2,)), ("RelativeLossDrop", (1e-3,)), ("ToleranceToOptimum", (2.0, 1e-3))):
        assert getattr(convergence, name)(*args)(losses, epoch) == getattr(ref_conv, name)(*args)(losses, epoch)


@pytest.mark.parametrize("clustered", [True, False])
def test_dense_classification_shape_labels_and_separation(clustered):
    """Same recipe as the reference (different generator streams): ±1
    labels, +1 first when clustered, and a planted separator that the
    labels agree with for most rows."""
    data = synthetic.dense_classification(torch.Generator().manual_seed(0), 2000, 8, clustered=clustered)
    ref = ref_synthetic.dense_classification(jax.random.PRNGKey(0), 2000, 8, clustered=clustered)
    assert data["x"].shape == tuple(ref["x"].shape) and data["x"].dtype == torch.float32
    y = data["y"]
    assert set(y.unique().tolist()) == {-1.0, 1.0} and int((y > 0).sum()) == 1000
    if clustered:
        assert torch.equal(y[:1000], torch.ones(1000))
    # the least-squares separator classifies most rows (noise=0.5 blurs some)
    w = torch.linalg.lstsq(data["x"], y[:, None]).solution[:, 0]
    assert float((torch.sign(data["x"] @ w) == y).float().mean()) > 0.8


def test_build_counter_counts_per_plan_and_globally():
    c = tracecount.fresh_counter()
    before = tracecount.GLOBAL["traces"]
    tracecount.count_build(c)
    tracecount.count_build()
    assert c["traces"] == 1 and tracecount.GLOBAL["traces"] == before + 2
