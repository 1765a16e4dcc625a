"""The fused-IGD CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and skips without one; a skip is not a
pass. On a machine with a card (the kernels build for sm_90a) run

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

This module imports neither JAX nor the JAX package, so it runs where
only PyTorch is installed (``--noconftest`` keeps the suite's conftest,
which loads the JAX package's obs layer, out of the run)."""

import numpy as np
import pytest
import torch

from repro_torch.kernels.igd_fused import kernel as K, ops, ref as R

# the reference's kernel tolerance (tests/test_kernels.py)
TOL = dict(rtol=2e-4, atol=2e-5)
# ragged (N % 256, D % 128), one warp up to D = 1024, then 8 and 16 warps
SHAPES = [(300, 7), (513, 16), (97, 1), (4096, 54), (300, 2000), (100, 4096)]

needs_card = pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")


def _inputs(n, d, seed=3):
    r = np.random.default_rng(seed)
    x = (r.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)
    y = np.sign(r.normal(size=n)).astype(np.float32)
    alpha = (0.1 / (1.0 + np.arange(n, dtype=np.float32) / n)).astype(np.float32)
    w0 = (0.01 * r.normal(size=d)).astype(np.float32)
    return [torch.from_numpy(v).cuda() for v in (x, y, alpha, w0)]


@needs_card
@pytest.mark.parametrize("n,d", SHAPES)
@pytest.mark.parametrize("loss", ["lr", "svm", "lsq"])
def test_cuda_kernels_match_plain_versions(loss, n, d):
    torch.backends.cuda.matmul.allow_tf32 = False
    x, y, alpha, w0 = _inputs(n, d)
    before = dict(K.launches)
    got = ops.igd_fold(x, y, alpha, w0, loss=loss)
    mb = ops.igd_fold_minibatch(x, y, alpha, w0, loss=loss)
    torch.cuda.synchronize()
    assert K.launches["igd_fold"] == before["igd_fold"] + 1
    assert K.launches["igd_fold_minibatch"] == before["igd_fold_minibatch"] + 1
    torch.testing.assert_close(got, R.igd_fold_ref(x, y, alpha, w0, loss=loss), **TOL)
    torch.testing.assert_close(mb, R.igd_fold_minibatch_ref(x, y, alpha, w0, loss=loss), **TOL)


@needs_card
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    x, y, alpha, w0 = _inputs(64, 8)
    with pytest.raises(ValueError, match="D=5000"):
        K.igd_fold(*_inputs(8, 5000))
    with pytest.raises(ValueError, match="contiguous"):
        K.igd_fold(x.t().contiguous().t(), y, alpha, w0)
    with pytest.raises(TypeError):
        K.igd_fold(x.double(), y, alpha, w0)
    with pytest.raises(ValueError, match="shapes"):
        K.igd_fold_minibatch(x, y[:10], alpha, w0)


@needs_card
def test_cuda_engine_plans_the_kernel_lane():
    from repro_torch import engine
    from repro_torch.data import synthetic

    table = synthetic.dense_classification(torch.Generator(device="cuda").manual_seed(0), 8192, 54)
    res = engine.Engine().run(engine.AnalyticsQuery(task="logreg", data=table, task_args={"dim": 54},
                                                    epochs=2, tolerance=0.0))
    assert res.plan.implementation == "cuda_fused" and res.kernel_launches == 2
    assert bool(torch.isfinite(res.model).all())
