"""The port's fused-IGD functions against the JAX package's Pallas kernels
(interpret mode, as the reference's own tests run them on the CPU) and
against the port's plain versions; plus the wrapper's checks, which run
before any launch. The CUDA kernels themselves need a card: their tests
are in tests/test_torch_cuda.py, and chip_smoke.py runs them on the H100."""

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
    path = K.library_path()
    assert path.parent == K.BUILD_DIR and path.name.startswith("libigd_fused-")
    assert "compute_90a" in " ".join(K.NVCC_FLAGS) and "--use_fast_math" not in K.NVCC_FLAGS
