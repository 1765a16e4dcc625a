"""The port's fused-IGD functions against the JAX package's Pallas kernels
(interpret mode, as the reference's own tests run them on the CPU) and
against the port's plain versions; plus the wrapper's checks, which run
before any launch. The CUDA kernels themselves need a card: their tests
are in tests/test_torch_cuda.py, and chip_smoke.py runs them on the H100."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.igd_fused import ops as ref_ops
from repro_torch.kernels.igd_fused import kernel as K, ops, ref as R

torch.set_num_threads(1)

# the reference's kernel tolerance (tests/test_kernels.py)
TOL = dict(rtol=2e-4, atol=2e-5)
LOSSES = ("lr", "svm", "lsq")
# ragged shapes: N % 256 != 0, D % 128 != 0, and aligned ones
SHAPES = [(300, 7), (513, 16), (256, 12), (97, 1)]
# the tiled fold: N around its 32-row tile, D up to the CUDA instance's 256
TILED_N = (0, 1, 31, 32, 33, 300, 4097)
TILED_D = (1, 7, 54, 256)


def _inputs(n, d, seed=3):
    r = np.random.default_rng(seed)
    x = (r.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)
    y = np.sign(r.normal(size=n)).astype(np.float32)
    alpha = (0.1 / (1.0 + np.arange(n, dtype=np.float32) / n)).astype(np.float32)
    w0 = (0.01 * r.normal(size=d)).astype(np.float32)
    return x, y, alpha, w0


def _both(fn_ref, fn_port, n, d, loss):
    a = _inputs(n, d)
    want = np.asarray(fn_ref(*(jnp.asarray(v) for v in a), loss=loss, use_kernel=True, interpret=True))
    got = fn_port(*(torch.from_numpy(v) for v in a), loss=loss)
    return got, want, a


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("n,d", SHAPES)
def test_igd_fold_matches_pallas_interpret_and_ref(loss, n, d):
    got, want, a = _both(ref_ops.igd_fold, ops.igd_fold, n, d, loss)
    assert got.shape == (d,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    plain = R.igd_fold_ref(*(torch.from_numpy(v) for v in a), loss=loss)
    assert torch.equal(got, plain)  # on the CPU, ops IS the plain version


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("n,d", SHAPES)
def test_igd_fold_minibatch_matches_pallas_interpret(loss, n, d):
    got, want, _ = _both(ref_ops.igd_fold_minibatch, ops.igd_fold_minibatch, n, d, loss)
    assert got.shape == (d,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("loss", LOSSES)
def test_minibatch_ragged_tail_divides_by_full_tile(loss):
    """The last tile of 300 rows holds 44; its mean is over 256 (the
    reference pads with alpha=0 rows). Dividing the tail by 44 instead
    moves w visibly, so this pins the divisor."""
    x, y, alpha, w0 = (torch.from_numpy(v) for v in _inputs(300, 5))
    got = ops.igd_fold_minibatch(x, y, alpha, w0, loss=loss)
    head = R.igd_fold_minibatch_ref(x[:256], y[:256], alpha[:256], w0, loss=loss)
    wx = x[256:] @ head
    m = wx if loss == "lsq" else y[256:] * wx
    c = R._grad_scale(loss, m, y[256:]) * alpha[256:]
    np.testing.assert_allclose(got.numpy(), (head - (c @ x[256:]) / 256).numpy(), rtol=1e-6, atol=1e-7)
    wrong = head - (c @ x[256:]) / 44
    assert not torch.allclose(got, wrong, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("d", TILED_D)
@pytest.mark.parametrize("n", TILED_N)
def test_igd_fold_tiled_ref_matches_per_row_fold_and_pallas(n, d, loss):
    """The CUDA kernel's algebra (p and the Gram matrix per 32-row tile, a
    scalar recurrence, one w update a tile) against the per-row fold and
    the reference's Pallas kernel in interpret mode. The Pallas kernel
    cannot take N = 0 rows, so there the reference's plain fold stands in."""
    a = _inputs(n, d)
    got = R.igd_fold_tiled_ref(*(torch.from_numpy(v) for v in a), loss=loss)
    assert got.shape == (d,) and got.dtype == torch.float32
    plain = R.igd_fold_ref(*(torch.from_numpy(v) for v in a), loss=loss)
    want = ref_ops.igd_fold(*(jnp.asarray(v) for v in a), loss=loss, use_kernel=n > 0, interpret=True)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if n == 0:
        assert torch.equal(got, torch.from_numpy(a[3]))


# the minibatch kernel's cluster order: N with a ragged last tile (44 rows;
# 9 rows, shorter than any share), D up to the cluster instance's 256,
# and the CTAs a cluster
SPLIT_N = (300, 521)
SPLIT_D = (1, 7, 54, 256)
SPLIT_PARTS = (1, 2, 8, 16)


@functools.lru_cache(maxsize=None)
def _pallas_minibatch(n, d, loss):
    a = _inputs(n, d)
    return np.asarray(ref_ops.igd_fold_minibatch(*(jnp.asarray(v) for v in a), loss=loss, use_kernel=True,
                                                 interpret=True))


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("parts", SPLIT_PARTS)
@pytest.mark.parametrize("d", SPLIT_D)
@pytest.mark.parametrize("n", SPLIT_N)
def test_minibatch_split_ref_matches_pallas_and_plain(n, d, parts, loss):
    """The CUDA cluster instance's order of sums (each tile's update as
    `parts` row-share partials, then across shares in rank order) against
    the reference's Pallas kernel in interpret mode and the plain
    minibatch fold; the ragged last tile still divides by 256."""
    a = [torch.from_numpy(v) for v in _inputs(n, d)]
    got = R.igd_fold_minibatch_split_ref(*a, loss=loss, parts=parts)
    assert got.shape == (d,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _pallas_minibatch(n, d, loss), **TOL)
    np.testing.assert_allclose(got.numpy(), R.igd_fold_minibatch_ref(*a, loss=loss).numpy(), **TOL)


def test_minibatch_split_ref_takes_zero_rows_and_refuses_uneven_parts():
    x, y, alpha, w0 = (torch.from_numpy(v) for v in _inputs(0, 5))
    assert torch.equal(R.igd_fold_minibatch_split_ref(x, y, alpha, w0, parts=8), w0)
    with pytest.raises(ValueError, match="evenly"):
        R.igd_fold_minibatch_split_ref(x, y, alpha, w0, parts=3)


def test_tiled_ref_restarts_from_any_row():
    """Folding in two calls, at a tile boundary or inside a tile, agrees
    with one call: the second call forms its first p from w itself, where
    one call forms it by the look-ahead X w_prev - (X X_prev^T) c_prev.
    One tile from w0 is the per-row fold's arithmetic regrouped."""
    x, y, alpha, w0 = (torch.from_numpy(v) for v in _inputs(96, 9))
    whole = R.igd_fold_tiled_ref(x, y, alpha, w0, loss="lr")
    for cut in (32, 64, 50):
        head = R.igd_fold_tiled_ref(x[:cut], y[:cut], alpha[:cut], w0, loss="lr")
        tail = R.igd_fold_tiled_ref(x[cut:], y[cut:], alpha[cut:], head, loss="lr")
        np.testing.assert_allclose(tail.numpy(), whole.numpy(), **TOL)
    np.testing.assert_allclose(R.igd_fold_tiled_ref(x[:32], y[:32], alpha[:32], w0, loss="lr").numpy(),
                               R.igd_fold_ref(x[:32], y[:32], alpha[:32], w0, loss="lr").numpy(), **TOL)


def _forest_like(n, d, seed):
    """dense_classification's recipe in numpy (labels +-1, rows pushed to
    their side of a random separator, noise), shuffled, with logreg's
    step sizes diminishing(0.5, decay=n)."""
    r = np.random.default_rng(seed)
    w_true = r.normal(size=d) / np.sqrt(d)
    y = np.concatenate([np.ones(n // 2), -np.ones(n - n // 2)])
    x = r.normal(size=(n, d)) / np.sqrt(d)
    x += ((y - x @ w_true) / np.sum(w_true**2))[:, None] * w_true[None, :]
    x += 0.5 * r.normal(size=(n, d)) / np.sqrt(d)
    perm = r.permutation(n)
    alpha = np.float32(0.5) / (np.float32(1.0) + np.arange(n, dtype=np.float32) / np.float32(n))
    return x[perm].astype(np.float32), y[perm].astype(np.float32), alpha, np.zeros(d, np.float32)


def test_tiled_fold_is_no_farther_from_float64_than_the_per_row_fold():
    """The per-row float32 fold rounds w at every row and drifts from an
    exact fold as N grows; the tiled fold rounds w once a tile. On 32,768
    Forest-shaped rows (lr) the tiled fold must be at least as near a
    float64 fold as the per-row one is."""
    a = [torch.from_numpy(v) for v in _forest_like(32_768, 54, seed=0)]
    exact = R.igd_fold_ref(*(t.double() for t in a), loss="lr")
    per_row = float((R.igd_fold_ref(*a, loss="lr").double() - exact).abs().max())
    tiled = float((R.igd_fold_tiled_ref(*a, loss="lr").double() - exact).abs().max())
    assert tiled <= per_row, (tiled, per_row)


def test_fold_ref_is_the_sequential_recurrence():
    """igd_fold_ref applies one transition per row in order: folding the
    rows in two calls equals one call."""
    x, y, alpha, w0 = (torch.from_numpy(v) for v in _inputs(64, 4))
    whole = R.igd_fold_ref(x, y, alpha, w0, loss="lr")
    split = R.igd_fold_ref(x[32:], y[32:], alpha[32:], R.igd_fold_ref(x[:32], y[:32], alpha[:32], w0, loss="lr"), loss="lr")
    assert torch.equal(whole, split)


def test_ops_rejects_mixed_devices_and_unknown_loss():
    x, y, alpha, w0 = (torch.from_numpy(v) for v in _inputs(8, 3))
    with pytest.raises(ValueError):
        ops.igd_fold(x, y, alpha, w0.to("meta"))
    with pytest.raises(ValueError):
        ops.igd_fold(x, y, alpha, w0, loss="huber")
    with pytest.raises(ValueError):
        ops.igd_fold_minibatch(x.to("meta"), y.to("meta"), alpha.to("meta"), w0.to("meta"))


def test_kernel_wrapper_checks_before_launch():
    """The CUDA wrapper refuses what its kernel does not take — checked
    in Python, before any library is built or loaded."""
    x, y, alpha, w0 = (torch.from_numpy(v) for v in _inputs(8, 3))
    with pytest.raises(ValueError, match="CUDA"):
        K.igd_fold(x, y, alpha, w0)  # CPU tensors never reach the kernel
    meta = [t.to("meta") for t in (x, y, alpha, w0)]
    with pytest.raises(ValueError):
        K.igd_fold_minibatch(*meta)


def test_launch_counter_reset():
    K.launches["igd_fold"] += 3
    K.reset_launches()
    assert K.launches == {"igd_fold": 0, "igd_fold_minibatch": 0}


def test_library_name_tracks_the_source():
    assert K.FOLD_GRAM_MAX_DIM == 256 < K.FOLD_REGISTER_MAX_DIM < K.FOLD_CLUSTER_SMEM_MAX_DIM
    assert K.MINIBATCH_CLUSTER_MAX_DIM == 256 < K.MINIBATCH_RESIDENT_MAX_DIM < K.MINIBATCH_SLICE_SMEM_MAX_DIM
    assert K.TILE % K.MINIBATCH_CLUSTER == 0 and K.MINIBATCH_SLICE_CLUSTER == K.FOLD_CLUSTER == 16
    path = K.library_path()
    assert path.parent == K.BUILD_DIR and path.name.startswith("libigd_fused-")
    assert "compute_90a" in " ".join(K.NVCC_FLAGS) and "--use_fast_math" not in K.NVCC_FLAGS


# -- lanes: B folds in one call (the counterpart of jax.vmap over the kernel)


def _lane_inputs(b, n, d, shared, seed=7):
    r = np.random.default_rng(seed)
    lead = () if shared else (b,)
    x = (r.normal(size=lead + (n, d)) / np.sqrt(d)).astype(np.float32)
    y = np.sign(r.normal(size=lead + (n,))).astype(np.float32)
    alpha = (0.1 / (1.0 + (np.arange(n) + r.integers(0, 5 * n, size=(b, 1))) / n)).astype(np.float32)
    w0 = (0.01 * r.normal(size=(b, d))).astype(np.float32)
    return x, y, alpha, w0


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "stacked"])
@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("name", ["igd_fold", "igd_fold_minibatch"])
def test_lanes_match_vmap_of_the_pallas_kernel(name, loss, shared):
    """B = 3 lanes through ops (the plain version's lane loop on the
    CPU) against jax.vmap of the reference's kernel in interpret mode,
    over one shared table and over stacked per-lane tables."""
    import jax

    a = _lane_inputs(3, 300, 7, shared)
    ref_fn = functools.partial(getattr(ref_ops, name), loss=loss, use_kernel=True, interpret=True)
    in_axes = (None, None, 0, 0) if shared else (0, 0, 0, 0)
    want = np.asarray(jax.vmap(ref_fn, in_axes=in_axes)(*(jnp.asarray(v) for v in a)))
    got = getattr(ops, name)(*(torch.from_numpy(v) for v in a), loss=loss)
    assert got.shape == (3, 7)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "stacked"])
def test_lanes_ref_is_each_lanes_own_fold(shared):
    """Lane b of the lane call is the one-lane call on lane b's inputs,
    bit for bit (what a lane launch guarantees on the card)."""
    x, y, alpha, w0 = (torch.from_numpy(v) for v in _lane_inputs(4, 97, 5, shared))
    got = ops.igd_fold(x, y, alpha, w0, loss="lr")
    for b in range(4):
        xb, yb = (x, y) if shared else (x[b], y[b])
        assert torch.equal(got[b], ops.igd_fold(xb, yb, alpha[b], w0[b], loss="lr"))


@pytest.mark.parametrize("bad", ["x_lanes", "y_shared", "alpha_rows", "w0_dim"])
def test_lane_layout_refuses_shapes_that_disagree(bad):
    x, y, alpha, w0 = (torch.from_numpy(v) for v in _lane_inputs(3, 64, 8, shared=False))
    assert K.lane_layout(x, y, alpha, w0) == (3, 64, 64)
    assert K.lane_layout(x[0], y[0], alpha, w0) == (3, 0, 64)
    assert K.lane_layout(x[0], y[0], alpha[0], w0[0]) == (1, 0, 0)
    args = {"x_lanes": (x[:2], y, alpha, w0), "y_shared": (x, y[0], alpha, w0),
            "alpha_rows": (x, y, alpha[:, :10], w0), "w0_dim": (x, y, alpha, w0[:, :4])}[bad]
    with pytest.raises(ValueError, match="lane shapes"):
        K.lane_layout(*args)
    with pytest.raises(ValueError, match="lane shapes"):
        ops.igd_fold_minibatch(*args)
