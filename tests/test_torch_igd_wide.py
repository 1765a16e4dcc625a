"""The fused-IGD functions at widths past the CUDA kernels' narrow
instances (igd_fold's middle instance ends at D = 4,096,
igd_fold_minibatch's row-share cluster at 256; the wide instances take
every D above: the minibatch's column-slice cluster keeps a tile's slice
resident up to D = 1,424 and reads it again past it), on the CPU: the
port's ``ops`` (its plain versions on CPU tensors) against the
reference's ops with ``use_kernel=False`` (its jnp oracles; the
minibatch's pads D to 128 and N to the tile, as its kernel does) on the
same seeded numpy inputs, and at D = 4,097 against the reference's Pallas
kernels in interpret mode; the minibatch also at D 257 and 1,000, the
column-slice cluster's resident widths, against both. igd_fold's wide
instance runs the tiled Gram algebra, so its own plain version
(``ref.igd_fold_tiled_ref``) is held to the same references, past each of
its boundaries (its shared-memory tier), with a ragged last sub-tile and
with fewer rows than one sub-tile. The wide CUDA instances themselves run
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phases 2 and
3f). About 40 s on one core."""

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
# past each narrow instance (the wide fold's w slices in shared memory)
WIDE_D = (4_097, 12_033, 65_537)
FOLD_TIER_D = K.FOLD_CLUSTER_SMEM_MAX_DIM + 1  # the wide fold's w in global memory
# the minibatch's column-slice cluster with a tile's slice resident: its first D and the middle's old one
MB_SLICE_D = (K.MINIBATCH_CLUSTER_MAX_DIM + 1, 1_000)
ROWS = 300  # a ragged last tile (300 = 256 + 44) and sub-tile (300 = 9 x 32 + 12)


def _inputs(n, d, seed=11):
    r = np.random.default_rng(seed)
    x = (r.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)
    y = np.sign(r.normal(size=n)).astype(np.float32)
    alpha = (0.1 / (1.0 + np.arange(n, dtype=np.float32) / n)).astype(np.float32)
    w0 = (0.01 * r.normal(size=d)).astype(np.float32)
    return x, y, alpha, w0


@functools.lru_cache(maxsize=2)
def _shared_inputs(n, d):
    return _inputs(n, d)


def test_the_wide_widths_cross_every_instance_boundary():
    assert WIDE_D[0] == K.FOLD_REGISTER_MAX_DIM + 1
    assert MB_SLICE_D[0] == K.MINIBATCH_CLUSTER_MAX_DIM + 1 and MB_SLICE_D[1] <= K.MINIBATCH_RESIDENT_MAX_DIM
    assert K.MINIBATCH_RESIDENT_MAX_DIM < WIDE_D[1] and WIDE_D[2] <= min(K.FOLD_CLUSTER_SMEM_MAX_DIM,
                                                                       K.MINIBATCH_SLICE_SMEM_MAX_DIM)
    assert FOLD_TIER_D > K.FOLD_CLUSTER_SMEM_MAX_DIM
    for name in ("cuda_fused", "cuda_minibatch"):
        assert all(K.supports(name, d) is None for d in WIDE_D + MB_SLICE_D + (FOLD_TIER_D,))


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("d", WIDE_D)
@pytest.mark.parametrize("name", ["igd_fold", "igd_fold_minibatch"])
def test_wide_fold_matches_the_references_ops(name, d, loss):
    a = _inputs(ROWS, d)
    want = np.asarray(getattr(ref_ops, name)(*(jnp.asarray(v) for v in a), loss=loss, use_kernel=False))
    got = getattr(ops, name)(*(torch.from_numpy(v) for v in a), loss=loss)
    assert got.shape == (d,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("name", ["igd_fold", "igd_fold_minibatch"])
def test_wide_fold_matches_the_pallas_kernel_in_interpret_mode(name, loss):
    a = _inputs(ROWS, K.FOLD_REGISTER_MAX_DIM + 1, seed=12)
    want = np.asarray(getattr(ref_ops, name)(*(jnp.asarray(v) for v in a), loss=loss, use_kernel=True,
                                             interpret=True))
    got = getattr(ops, name)(*(torch.from_numpy(v) for v in a), loss=loss)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("d", MB_SLICE_D)
def test_minibatch_slice_widths_match_the_references_ops_and_pallas_kernel(d, loss):
    """igd_fold_minibatch past D 256 against the reference's jnp oracle and
    its Pallas kernel in interpret mode (both pad D to 128 and N to the
    tile; the port takes the shape as it is)."""
    a = _inputs(ROWS, d, seed=14)
    got = ops.igd_fold_minibatch(*(torch.from_numpy(v) for v in a), loss=loss)
    assert got.shape == (d,) and got.dtype == torch.float32
    for use_kernel in (False, True):
        want = np.asarray(ref_ops.igd_fold_minibatch(*(jnp.asarray(v) for v in a), loss=loss, use_kernel=use_kernel,
                                                     interpret=True))
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name", ["igd_fold", "igd_fold_minibatch"])
def test_wide_lanes_match_their_single_folds(name):
    """B = 3 lanes over a shared table at D = 12,033: each lane the plain
    fold of its own steps and start."""
    x, y, alpha, w0 = (torch.from_numpy(v) for v in _inputs(64, WIDE_D[1], seed=13))
    a_b = torch.stack([alpha, 0.5 * alpha, 2.0 * alpha])
    w_b = torch.stack([w0, -w0, torch.zeros_like(w0)])
    fn = getattr(ops, name)
    got = fn(x, y, a_b, w_b, loss="lsq")
    for i in range(3):
        assert torch.equal(got[i], fn(x, y, a_b[i], w_b[i], loss="lsq"))


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("d", WIDE_D + (FOLD_TIER_D,))
@pytest.mark.parametrize("n", [ROWS, 31])
def test_wide_fold_plain_version_matches_the_references_ops(n, d, loss):
    """igd_fold's wide instance's plain version (the tiled fold) against
    the reference's per-row jnp oracle."""
    a = _shared_inputs(n, d)
    want = np.asarray(ref_ops.igd_fold(*(jnp.asarray(v) for v in a), loss=loss, use_kernel=False))
    got = R.igd_fold_tiled_ref(*(torch.from_numpy(v) for v in a), loss=loss)
    assert got.shape == (d,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("loss", LOSSES)
def test_wide_fold_plain_version_matches_the_pallas_kernel_in_interpret_mode(loss):
    a = _inputs(ROWS, K.FOLD_REGISTER_MAX_DIM + 1, seed=12)
    want = np.asarray(ref_ops.igd_fold(*(jnp.asarray(v) for v in a), loss=loss, use_kernel=True, interpret=True))
    got = R.igd_fold_tiled_ref(*(torch.from_numpy(v) for v in a), loss=loss)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
