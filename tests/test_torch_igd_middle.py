"""igd_fold's middle instance (256 < D <= 4,096) on the CPU: the tiled Gram
look-ahead over a cluster whose CTA count D picks
(``kernel.fold_middle_ctas``), whose order of sums is
``ref.igd_fold_tiled_ref``. That plain version is held, on the same
seeded numpy inputs, to the reference's per-row jnp oracle
(``repro.kernels.igd_fused.ops.igd_fold(use_kernel=False)``) at the
instance's first and last widths, at 300, 1,000 and 1,025 and on both
sides of every cluster-size boundary and of the width past which 16 CTAs'
slices pass the cap; to the reference's Pallas kernel in
interpret mode at D 384; and, over a 4,096-row table, to a float64 fold
(the per-row float32 fold drifts from both with N). The CUDA instance
itself runs on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``
phases 2, 3f and 4)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.igd_fused import ops as ref_ops
from repro_torch.kernels.igd_fused import kernel as K, ops, ref as R

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-5)  # the reference's kernel tolerance (tests/test_kernels.py)
LOSSES = ("lr", "svm", "lsq")
ROWS = 300  # a ragged last sub-tile (300 = 9 x 32 + 12)
# the last D of each cluster size the middle instance takes, but its last
LAST_OF_SIZE = K.fold_middle_widths()[1:-1]
# the 16-CTA slices pass FOLD_MIDDLE_MAX_SLICE columns after this D
FULL_16 = K.FOLD_CLUSTER * K.FOLD_MIDDLE_MAX_SLICE
# its first and last D, 300, 1,000 and 1,025, both sides of every
# cluster-size boundary and of the 16-CTA slices' cap
MIDDLE_D = tuple(sorted({K.FOLD_GRAM_MAX_DIM + 1, 300, 1_000, 1_025, FULL_16, FULL_16 + 1, K.FOLD_REGISTER_MAX_DIM}
                        | set(LAST_OF_SIZE) | {d + 1 for d in LAST_OF_SIZE}))


def _inputs(n, d, seed=21):
    r = np.random.default_rng(seed)
    x = (r.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)
    y = np.sign(r.normal(size=n)).astype(np.float32)
    alpha = (0.1 / (1.0 + np.arange(n, dtype=np.float32) / n)).astype(np.float32)
    w0 = (0.01 * r.normal(size=d)).astype(np.float32)
    return x, y, alpha, w0


@functools.lru_cache(maxsize=2)
def _shared_inputs(n, d):
    return _inputs(n, d)


def test_the_middle_cluster_sizes_follow_d_alone():
    """The fewest CTAs whose slices are at most FOLD_MIDDLE_MAX_SLICE
    columns, twice as many at each boundary, and 16 where even 16 CTAs'
    slices are wider (to D 4,096)."""
    assert 0 < K.FOLD_MIDDLE_MAX_SLICE and FULL_16 < K.FOLD_REGISTER_MAX_DIM
    sizes = [K.fold_middle_ctas(d) for d in range(K.FOLD_GRAM_MAX_DIM + 1, K.FOLD_REGISTER_MAX_DIM + 1)]
    assert sizes == sorted(sizes) and set(sizes) <= {1, 2, 4, 8, 16} and sizes[-1] == K.FOLD_CLUSTER
    for d, ctas in zip(range(K.FOLD_GRAM_MAX_DIM + 1, K.FOLD_REGISTER_MAX_DIM + 1), sizes):
        assert -(-d // ctas) <= K.FOLD_MIDDLE_MAX_SLICE or (ctas == K.FOLD_CLUSTER and d > FULL_16)
        assert ctas == 1 or -(-d // (ctas // 2)) > K.FOLD_MIDDLE_MAX_SLICE  # the fewest that keep the cap
    for d in LAST_OF_SIZE:
        assert K.fold_middle_ctas(d + 1) == 2 * K.fold_middle_ctas(d)
    for d in (K.FOLD_GRAM_MAX_DIM, K.FOLD_REGISTER_MAX_DIM + 1):
        with pytest.raises(ValueError, match=f"D={d}"):
            K.fold_middle_ctas(d)
    assert all(K.supports("cuda_fused", d) is None for d in MIDDLE_D)


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("d", MIDDLE_D)
@pytest.mark.parametrize("n", [ROWS, 31])
def test_middle_plain_version_matches_the_references_ops(n, d, loss):
    """The middle instance's order (the tiled fold) against the
    reference's per-row jnp oracle."""
    a = _shared_inputs(n, d)
    want = np.asarray(ref_ops.igd_fold(*(jnp.asarray(v) for v in a), loss=loss, use_kernel=False))
    got = R.igd_fold_tiled_ref(*(torch.from_numpy(v) for v in a), loss=loss)
    assert got.shape == (d,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("loss", LOSSES)
def test_middle_plain_version_matches_the_pallas_kernel_in_interpret_mode(loss):
    a = _inputs(256, 384, seed=22)
    want = np.asarray(ref_ops.igd_fold(*(jnp.asarray(v) for v in a), loss=loss, use_kernel=True, interpret=True))
    got = R.igd_fold_tiled_ref(*(torch.from_numpy(v) for v in a), loss=loss)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # and the port's ops on the CPU (the per-row fold) to the same kernel
    np.testing.assert_allclose(ops.igd_fold(*(torch.from_numpy(v) for v in a), loss=loss).numpy(), want, **TOL)


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("d", [300, 1_000, K.FOLD_REGISTER_MAX_DIM])
def test_middle_plain_version_stays_near_a_float64_fold(d, loss):
    """Over 4,096 rows the tiled float32 fold is held to a float64 fold
    (the per-row float32 fold rounds w every row and drifts with N)."""
    x, y, alpha, w0 = (torch.from_numpy(v) for v in _inputs(4_096, d, seed=23))
    exact = R.igd_fold_ref(x.double(), y.double(), alpha.double(), w0.double(), loss=loss)
    got = R.igd_fold_tiled_ref(x, y, alpha, w0, loss=loss).double()
    torch.testing.assert_close(got, exact, **TOL)
