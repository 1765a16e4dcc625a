"""The port's CUDA kernels (fused IGD, flash attention, flash decode)
against their plain versions, on the card.

Every test here needs a CUDA card and skips without one; a skip is not a
pass. On a machine with a card (the kernels build for sm_90a) run

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

This module imports neither JAX nor the JAX package, so it runs where
only PyTorch is installed (``--noconftest`` keeps the suite's conftest,
which loads the JAX package's obs layer, out of the run)."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels.igd_fused import kernel as K, ops, ref as R

# the reference's kernel tolerance (tests/test_kernels.py)
TOL = dict(rtol=2e-4, atol=2e-5)
# ragged (N % 256, D % 128), one warp up to D = 1024, then 8 and 16 warps
SHAPES = [(300, 7), (513, 16), (97, 1), (4096, 54), (300, 2000), (100, 4096)]

# igd_fold: N around the tiled instance's 32-row sub-tile, D on both sides
# of its boundary with the per-row instance (256)
FOLD_N = (1, 31, 33, 16_385)
FOLD_D = (54, 128, 256, 257)

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
@pytest.mark.parametrize("loss", ["lr", "svm", "lsq"])
@pytest.mark.parametrize("d", FOLD_D)
@pytest.mark.parametrize("n", FOLD_N)
def test_cuda_igd_fold_matches_per_row_and_tiled_folds(n, d, loss):
    """Both igd_fold instances against the per-row fold and the tiled
    fold (the plain versions run on the CPU, where small ops are cheaper)."""
    args = _inputs(n, d)
    before = K.launches["igd_fold"]
    got = K.igd_fold(*args, loss=loss).cpu()
    assert K.launches["igd_fold"] == before + 1
    on_cpu = [t.cpu() for t in args]
    torch.testing.assert_close(got, R.igd_fold_ref(*on_cpu, loss=loss), **TOL)
    torch.testing.assert_close(got, R.igd_fold_tiled_ref(*on_cpu, loss=loss), **TOL)


@needs_card
def test_cuda_igd_fold_takes_zero_rows_and_unaligned_rows():
    """N = 0 returns w0; x starting off a 16-byte boundary takes the
    4-byte copies and gives the same w."""
    x, y, alpha, w0 = _inputs(300, 128)
    torch.testing.assert_close(K.igd_fold(x[:0], y[:0], alpha[:0], w0), w0, rtol=0, atol=0)
    shifted = torch.empty(300 * 128 + 1, device=x.device)[1:].view(300, 128)
    shifted.copy_(x)
    torch.testing.assert_close(K.igd_fold(shifted, y, alpha, w0), K.igd_fold(x, y, alpha, w0), rtol=0, atol=0)


# igd_fold_minibatch: N around the 256-row tile and the cluster's span of
# tiles, D on both sides of the cluster instance's bound (256) up to the
# one-block kernel's limit
MB_K = K.MINIBATCH_CLUSTER
MB_N = (0, 1, 255, 257, 256 * MB_K - 1, 256 * MB_K + 1, 16_385)
MB_D = (1, 54, 256, 257, K.MINIBATCH_MAX_DIM)


def _card_inputs(n, d, seed=5):
    """_inputs' recipe drawn on the card (the widest shapes hold 200M floats)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n, d), generator=g, device="cuda") / d**0.5
    y = torch.sign(torch.randn((n,), generator=g, device="cuda"))
    alpha = 0.1 / (1.0 + torch.arange(n, device="cuda", dtype=torch.float32) / max(n, 1))
    w0 = 0.01 * torch.randn((d,), generator=g, device="cuda")
    return x, y, alpha, w0


@needs_card
@pytest.mark.parametrize("loss", ["lr", "svm", "lsq"])
@pytest.mark.parametrize("d", MB_D)
@pytest.mark.parametrize("n", MB_N)
def test_cuda_igd_fold_minibatch_matches_plain_and_split_folds(n, d, loss):
    """Both igd_fold_minibatch instances against the plain fold and the
    plain version of the cluster's order (shares of 256 / MB_K rows, then
    across shares in rank order); N = 0 returns w0 exactly."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _card_inputs(n, d)
    before = K.launches["igd_fold_minibatch"]
    got = K.igd_fold_minibatch(*args, loss=loss)
    torch.cuda.synchronize()
    assert K.launches["igd_fold_minibatch"] == before + 1
    torch.testing.assert_close(got, R.igd_fold_minibatch_ref(*args, loss=loss), **TOL)
    torch.testing.assert_close(got, R.igd_fold_minibatch_split_ref(*args, loss=loss, parts=MB_K), **TOL)
    if n == 0:
        assert torch.equal(got, args[3])


@needs_card
@pytest.mark.parametrize("d", [54, 256, 300])
def test_cuda_igd_fold_minibatch_takes_unaligned_rows(d):
    """x, y and alpha starting off a 16-byte boundary (the cluster instance
    then copies with plain loads, not bulk copies) give the same w bit for
    bit, and so does a table sliced at an odd row."""
    x, y, alpha, w0 = _card_inputs(3_001, d)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=t.device)[1:].view(t.shape)
        buf.copy_(t)
        return buf

    for loss in ("lr", "svm", "lsq"):
        want = K.igd_fold_minibatch(x, y, alpha, w0, loss=loss)
        got = K.igd_fold_minibatch(shifted(x), shifted(y), shifted(alpha), w0, loss=loss)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        odd = K.igd_fold_minibatch(x[1:], y[1:], alpha[1:], w0, loss=loss)
        torch.testing.assert_close(odd, R.igd_fold_minibatch_split_ref(x[1:], y[1:], alpha[1:], w0, loss=loss,
                                                                        parts=MB_K), **TOL)


@needs_card
def test_cuda_minibatch_step_probe_times_the_cluster_step():
    cycles, seconds = K.minibatch_step_probe("lsq", 54, steps=256)
    assert cycles > 0 and seconds > 0
    cluster, smem = K.minibatch_design(54)
    assert cluster == MB_K and 0 < smem <= 232_448
    assert K.minibatch_design(257) == (1, 0)


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


@needs_card
@pytest.mark.parametrize("task,d", [("logreg", 4_097), ("least_squares", 12_033)])
def test_cuda_wide_query_plans_past_the_kernels_and_matches_the_cpu_run(task, d):
    """Past igd_fold's D (4,096), and past igd_fold_minibatch's (12,032):
    the card plans as the CPU does (probe (e) prices only the kernels that
    take D, the eager fold wins), runs, and equals the CPU run with the
    same draws; a hint past a kernel's limit raises naming it."""
    from repro_torch import engine
    from repro_torch.core import draws
    from repro_torch.data import synthetic

    torch.backends.cuda.matmul.allow_tf32 = False
    table = synthetic.dense_classification(torch.Generator().manual_seed(7), 1_024, d)
    on_card = {k: v.cuda() for k, v in table.items()}

    def query(data, **hints):
        return engine.AnalyticsQuery(task=task, data=data, task_args={"dim": d}, epochs=2, tolerance=0.0,
                                     hints=hints)

    eng = engine.Engine(draws=draws.HostDraws())
    report = eng.explain(query(on_card))
    assert report.chosen.implementation == "torch_fold"
    assert set(report.calibration.impl_per_row) == ({"cuda_minibatch"} if d <= K.MINIBATCH_MAX_DIM else set())
    card = eng.run(query(on_card))
    host = engine.Engine(device="cpu", draws=draws.HostDraws()).run(query(table), plan=report.chosen)
    torch.testing.assert_close(card.model.cpu(), host.model, **TOL)
    assert card.kernel_launches == 0
    for impl, limit in (("cuda_fused", "4096"), ("cuda_minibatch", "12032")):
        if K.supports(impl, d) is not None:
            with pytest.raises(ValueError, match=limit):
                eng.explain(query(on_card, implementation=impl))
    if d <= K.MINIBATCH_MAX_DIM:  # the one-block minibatch kernel still takes this width
        hinted = eng.run(query(on_card, implementation="cuda_minibatch"))
        want = engine.Engine(device="cpu", draws=draws.HostDraws()).run(query(table), plan=hinted.plan)
        torch.testing.assert_close(hinted.model.cpu(), want.model, **TOL)
        assert hinted.kernel_launches == 2


# lane launches: (lanes, N, D) across the sub-tile, the tile and the
# instance boundaries (D 300: the per-row fold and the one-block minibatch)
LANE_CASES = [(1, 33, 54), (3, 257, 54), (3, 1000, 200), (4, 31, 300), (3, 2049, 300), (32, 513, 54)]


def _lane_inputs(b, n, d, shared, seed=5):
    r = np.random.default_rng(seed)
    lead = () if shared else (b,)
    x = (r.normal(size=lead + (n, d)) / np.sqrt(d)).astype(np.float32)
    y = np.sign(r.normal(size=lead + (n,))).astype(np.float32)
    alpha = (0.1 / (1.0 + (np.arange(n) + r.integers(0, 5 * n, size=(b, 1))) / n)).astype(np.float32)
    w0 = (0.01 * r.normal(size=(b, d))).astype(np.float32)
    return [torch.from_numpy(v).cuda() for v in (x, y, alpha, w0)]


@needs_card
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "stacked"])
@pytest.mark.parametrize("b,n,d", LANE_CASES)
@pytest.mark.parametrize("name", ["igd_fold", "igd_fold_minibatch"])
def test_cuda_lane_launch_matches_single_lanes_and_plain_version(name, b, n, d, shared):
    """B lanes in one launch (one count): every lane equals its own
    one-lane launch bit for bit, and the plain version within the
    kernel tolerance."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x, y, alpha, w0 = _lane_inputs(b, n, d, shared)
    kernel, plain = getattr(K, name), getattr(R, f"{name}_ref")
    before = K.launches[name]
    got = kernel(x, y, alpha, w0, loss="lr")
    assert K.launches[name] == before + 1 and got.shape == (b, d)
    for i in range(b):
        xi, yi = (x, y) if shared else (x[i], y[i])
        assert torch.equal(got[i], kernel(xi, yi, alpha[i].contiguous(), w0[i].contiguous(), loss="lr")), i
    torch.testing.assert_close(got, R.lanes_ref(plain, x, y, alpha, w0, loss="lr"), **TOL)


@needs_card
def test_cuda_lane_wrapper_refuses_lane_shapes_that_disagree():
    x, y, alpha, w0 = _lane_inputs(3, 64, 8, shared=False)
    with pytest.raises(ValueError, match="lane shapes"):
        K.igd_fold(x[:2], y, alpha, w0)
    with pytest.raises(ValueError, match="lane shapes"):
        K.igd_fold_minibatch(x[0], y, alpha, w0)  # shared x, stacked y
    with pytest.raises(ValueError, match="lane shapes"):
        K.igd_fold(x, y, alpha[:, :10].contiguous(), w0)


@needs_card
@pytest.mark.parametrize("impl", ["cuda_fused", "cuda_minibatch"])
@pytest.mark.parametrize("ordering", ["clustered", "shuffle_once", "shuffle_always"])
def test_cuda_served_kernel_lanes_equal_their_singleton_runs(ordering, impl):
    """A masked fused batch of kernel lanes is one launch an epoch, and
    each lane is its own Engine.run bit for bit."""
    from repro_torch import engine
    from repro_torch.data import synthetic
    from repro_torch.engine import serve

    table = synthetic.dense_classification(torch.Generator(device="cuda").manual_seed(2), 3000, 54)
    hints = {"ordering": ordering, "scheme": "serial", "implementation": impl}
    queries = [engine.AnalyticsQuery(task="logreg", data=table, task_args={"dim": 54}, epochs=e,
                                     tolerance=0.0, seed=s, hints=hints) for s, e in enumerate((3, 2, 3))]
    eng = engine.Engine()
    singles = [eng.run(q) for q in queries]
    srv = serve.ServingEngine(serve.ServeConfig(max_batch=4), engine=eng)
    tickets = [srv.submit(q) for q in queries]
    srv.drain()
    assert srv.stats["batches"] == 1 and srv.stats["masked_batches"] == 1
    for t, ref in zip(tickets, singles):
        assert t.error is None and t.result.batch_size == 3 and t.result.kernel_launches == 3
        assert torch.equal(t.result.model, ref.model)


@needs_card
@pytest.mark.parametrize("impl", ["cuda_fused", "cuda_minibatch"])
def test_cuda_chunk_stream_moves_host_chunks_and_matches_the_resident_run(impl):
    """A ChunkedTable on the host streams to the card a chunk a launch;
    the fold lands within the kernel tolerance of the resident run."""
    from repro_torch import engine
    from repro_torch.data import synthetic

    table = synthetic.dense_classification(torch.Generator().manual_seed(3), 5 * 1024 + 300, 54)
    tab = engine.ChunkedTable.from_arrays(table, 1024)
    eng = engine.Engine()
    q = engine.AnalyticsQuery(task="logreg", data=tab, task_args={"dim": 54}, epochs=2, tolerance=0.0,
                              hints={"source": "table", "implementation": impl})
    res = eng.run(q)
    assert res.plan.source == "table" and res.kernel_launches == 2 * tab.num_chunks
    assert eng.stats["bytes_to_device"] >= 2 * tab.data_bytes()
    resident = {k: v.cuda() for k, v in table.items()}
    ref = eng.run(engine.AnalyticsQuery(task="logreg", data=resident, task_args={"dim": 54}, epochs=2,
                                        tolerance=0.0), plan=dataclasses.replace(res.plan, source="memory"))
    if impl == "cuda_fused":
        torch.testing.assert_close(res.model, ref.model, **TOL)
    else:  # 1,024-row chunks are whole tiles: the same mean-gradient steps
        assert torch.equal(res.model, ref.model)


@needs_card
@pytest.mark.parametrize("name", ["igd_fold", "igd_fold_minibatch"])
@pytest.mark.parametrize("s,per,n,d", [(4, 3, 2_049, 54), (2, 8, 257, 54), (3, 2, 300, 300)])
def test_cuda_segment_lanes_match_one_lane_launches(name, s, per, n, d):
    """S segments under S * per lanes (the fused sharded batch's layout:
    lane l reads segment l // per): one launch, every lane its one-lane
    launch on its segment bit for bit, the plain version within the
    kernel tolerance."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x, y, _, _ = _lane_inputs(s, n, d, shared=False)
    _, _, alpha, w0 = _lane_inputs(s * per, n, d, shared=True, seed=9)
    kernel, plain = getattr(K, name), getattr(R, f"{name}_ref")
    before = K.launches[name]
    got = kernel(x, y, alpha, w0, loss="lr")
    assert K.launches[name] == before + 1 and got.shape == (s * per, d)
    for lane in range(s * per):
        one = kernel(x[lane // per], y[lane // per], alpha[lane].contiguous(), w0[lane].contiguous(), loss="lr")
        assert torch.equal(got[lane], one), lane
    torch.testing.assert_close(got, R.lanes_ref(plain, x, y, alpha, w0, loss="lr"), **TOL)


def _sharded_query(table, seed=0, epochs=3, **hints):
    from repro_torch import engine

    return engine.AnalyticsQuery(task="logreg", data=table, task_args={"dim": 54}, epochs=epochs,
                                 tolerance=0.0, seed=seed, hints=hints)


def _sharded_plan(ordering, impl, k, h=1):
    from repro_torch import engine

    return engine.Plan(ordering, implementation=impl, parallelism="sharded", num_shards=k, merge_period=h)


@needs_card
@pytest.mark.parametrize("impl", ["torch_fold", "cuda_fused", "cuda_minibatch"])
@pytest.mark.parametrize("ordering", ["clustered", "shuffle_once", "shuffle_always"])
def test_cuda_sharded_k1_is_the_singleton_run(ordering, impl):
    """sharded(k=1) on the card is Engine.run bit for bit, for every
    ordering and lane body (the eager fold on a short table)."""
    from repro_torch import engine
    from repro_torch.data import synthetic

    n = 256 if impl == "torch_fold" else 3000
    table = synthetic.dense_classification(torch.Generator(device="cuda").manual_seed(4), n, 54)
    eng = engine.Engine()
    q = _sharded_query(table, seed=5)
    base = eng.run(q, plan=engine.Plan(ordering, implementation=impl))
    sh = eng.run(q, plan=_sharded_plan(ordering, impl, 1))
    assert torch.equal(base.model, sh.model) and base.losses == sh.losses
    assert sh.kernel_launches == base.kernel_launches == (0 if impl == "torch_fold" else 3)


@needs_card
@pytest.mark.parametrize("impl", ["torch_fold", "cuda_fused", "cuda_minibatch"])
@pytest.mark.parametrize("ordering", ["clustered", "shuffle_once", "shuffle_always"])
def test_cuda_sharded_run_matches_the_cpu_run(ordering, impl):
    """k = 4, H = 2 on the card and on the CPU with the same draws
    (``draws.HostDraws``): within the kernel tolerance; a kernel epoch is
    one lane launch of the 4 shards."""
    from repro_torch import engine
    from repro_torch.core import draws
    from repro_torch.data import synthetic

    torch.backends.cuda.matmul.allow_tf32 = False
    n = 256 if impl == "torch_fold" else 4096
    table = synthetic.dense_classification(torch.Generator().manual_seed(6), n, 54)
    plan = _sharded_plan(ordering, impl, 4, h=2)
    card = engine.Engine(draws=draws.HostDraws()).run(_sharded_query({k: v.cuda() for k, v in table.items()}),
                                                      plan=plan)
    host = engine.Engine(device="cpu", draws=draws.HostDraws()).run(_sharded_query(table), plan=plan)
    torch.testing.assert_close(card.model.cpu(), host.model, **TOL)
    assert card.kernel_launches == (0 if impl == "torch_fold" else 3)


@needs_card
@pytest.mark.parametrize("impl", ["cuda_fused", "cuda_minibatch"])
@pytest.mark.parametrize("ordering", ["clustered", "shuffle_once", "shuffle_always"])
def test_cuda_served_sharded_kernel_lanes_equal_their_own_runs(ordering, impl):
    """A masked fused sharded batch (3 queries x 4 shards) is one lane
    launch of 12 lanes an epoch, and each query is its own sharded
    Engine.run bit for bit."""
    from repro_torch import engine
    from repro_torch.data import synthetic
    from repro_torch.engine import serve

    table = synthetic.dense_classification(torch.Generator(device="cuda").manual_seed(2), 4 * 1000, 54)
    hints = {"ordering": ordering, "parallelism": "sharded", "num_shards": 4, "merge_period": 1,
             "implementation": impl}
    queries = [_sharded_query(table, seed=s, epochs=e, **hints) for s, e in enumerate((3, 2, 3))]
    eng = engine.Engine()
    singles = [eng.run(q) for q in queries]
    assert all(r.plan.parallelism == "sharded" and r.kernel_launches == r.epochs for r in singles)
    srv = serve.ServingEngine(serve.ServeConfig(max_batch=4), engine=eng)
    tickets = [srv.submit(q) for q in queries]
    srv.drain()
    assert srv.stats["batches"] == 1 and srv.stats["masked_batches"] == 1
    for t, ref in zip(tickets, singles):
        assert t.error is None and t.result.batch_size == 3 and t.result.kernel_launches == 3
        assert torch.equal(t.result.model, ref.model)


# the schemes of paper §3.3-3.4: (ordering, scheme, plan fields)
SCHEME_PLANS = [("clustered", "segmented", {"num_segments": 8}), ("shuffle_once", "segmented", {"num_segments": 2}),
                ("shuffle_always", "shared_memory", {"sm_scheme": "lock"}),
                ("shuffle_once", "shared_memory", {"sm_scheme": "aig"}),
                ("clustered", "shared_memory", {"sm_scheme": "nolock"}),
                ("clustered", "mrs", {"mrs_buffer": 64}), ("clustered", "mrs", {"mrs_buffer": 100, "mrs_ratio": 1})]


@needs_card
@pytest.mark.parametrize("task,task_args", [("svm", {}), ("logreg", {"mu": 1e-3})])
@pytest.mark.parametrize("ordering,scheme,fields", SCHEME_PLANS)
def test_cuda_scheme_plans_match_the_cpu_run(ordering, scheme, fields, task, task_args):
    """Each non-serial scheme runs eagerly on the card (no kernel launch)
    and lands where the same plan lands on the CPU with the same draws."""
    from repro_torch import engine
    from repro_torch.core import draws
    from repro_torch.data import synthetic
    from repro_torch.engine import planner

    table = synthetic.dense_classification(torch.Generator().manual_seed(1), 1024, 54)
    plan = planner.Plan(ordering, scheme, **fields)
    res = {}
    for device in ("cuda", "cpu"):
        q = engine.AnalyticsQuery(task=task, data={k: v.to(device) for k, v in table.items()},
                                  task_args={"dim": 54, **task_args}, epochs=3, tolerance=0.0)
        res[device] = engine.Engine(device=device, draws=draws.HostDraws()).run(q, plan=plan)
    assert res["cuda"].model.device.type == "cuda" and res["cuda"].kernel_launches == 0
    assert bool(torch.isfinite(res["cuda"].model).all())
    torch.testing.assert_close(res["cuda"].model.cpu(), res["cpu"].model, **TOL)
    np.testing.assert_allclose(res["cuda"].losses, res["cpu"].losses, rtol=TOL["rtol"])


@needs_card
def test_cuda_engine_falls_back_to_mrs_under_a_budget():
    """An ineligible query (L1 prox) over a label-clustered table twice its
    memory budget: the card's planner streams it through MRS."""
    from repro_torch import engine
    from repro_torch.data import synthetic

    table = synthetic.dense_classification(torch.Generator(device="cuda").manual_seed(0), 4096, 54)
    nbytes = sum(v.numel() * v.element_size() for v in table.values())
    q = engine.AnalyticsQuery(task="logreg", data=table, task_args={"dim": 54, "mu": 1e-4}, epochs=2,
                              tolerance=0.0, memory_budget_bytes=nbytes // 2)
    res = engine.Engine().run(q)
    assert res.plan.scheme == "mrs" and res.plan.mrs_buffer == 1024
    assert res.kernel_launches == 0 and bool(torch.isfinite(res.model).all())


# the reference's attention/decode tolerances (tests/test_kernels.py)
ATTN_TOLS = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
DECODE_TOLS = {torch.float32: 5e-5, torch.bfloat16: 2e-2}
# the reference's shapes, ragged S, and llama3.2-3b's heads at B=1
ATTN_SHAPES = [(2, 256, 4, 2, 64), (1, 128, 4, 4, 128), (2, 384, 6, 2, 32),
               (1, 300, 4, 2, 64), (1, 1000, 8, 2, 128), (1, 2048, 24, 8, 128), (1, 77, 3, 1, 40)]
# (B, H, Kv, hd, S, length): the reference's, llama3.2-3b's at the serving
# shape, and 16 q heads per kv head (four head groups)
DECODE_SHAPES = [(2, 4, 2, 64, 1024, 700), (1, 8, 8, 128, 512, 512), (4, 4, 1, 32, 2048, 1),
                 (8, 24, 8, 128, 2176, 1), (8, 24, 8, 128, 2176, 700), (8, 24, 8, 128, 2176, 2176),
                 (1, 32, 2, 64, 300, 299)]


def _normal(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


@needs_card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,hd", ATTN_SHAPES)
def test_cuda_flash_attention_matches_plain_version(b, s, h, kv, hd, dtype):
    from repro_torch.kernels.attention import kernel as AK, ops as A, ref as AR

    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (_normal(shape, dtype, i) for i, shape in enumerate(((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))))
    before = AK.launches["flash_attention"]
    got = A.mha(q, k, v)
    torch.cuda.synchronize()
    assert AK.launches["flash_attention"] == before + 1 and got.dtype == dtype
    tol = ATTN_TOLS[dtype]
    torch.testing.assert_close(got.float(), AR.mha_ref(q, k, v).float(), rtol=tol, atol=tol)


@needs_card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,hd,s,length", DECODE_SHAPES)
def test_cuda_flash_decode_matches_plain_version(b, h, kv, hd, s, length, dtype):
    from repro_torch.kernels.decode import kernel as DK, ref as DR

    torch.backends.cuda.matmul.allow_tf32 = False
    q, kc, vc = (_normal(shape, dtype, i) for i, shape in enumerate(((b, h, hd), (b, s, kv, hd), (b, s, kv, hd))))
    before = DK.launches["flash_decode"]
    out, m, l = DK.flash_decode(q, kc, vc, length)
    torch.cuda.synchronize()
    assert DK.launches["flash_decode"] == before + 1
    want = DR.decode_attention_ref(q, kc, vc, length)
    tol = DECODE_TOLS[dtype]
    torch.testing.assert_close(out.float(), want[0].float(), rtol=tol, atol=tol)
    torch.testing.assert_close(m, want[1], rtol=tol, atol=tol)
    torch.testing.assert_close(l, want[2], rtol=tol, atol=tol)


@needs_card
def test_cuda_kernels_read_the_cache_in_place_and_mask_its_tail():
    """Strided views of a [B, S_max, Kv, hd] cache give what contiguous
    copies give; decode ignores the cache past length; length 0 is the
    Pallas kernel's empty result."""
    from repro_torch.kernels.attention import ops as A
    from repro_torch.kernels.decode import kernel as DK

    b, s_max, h, kv, hd, s = 2, 512, 6, 2, 64, 200
    q = _normal((b, s, h, hd), torch.bfloat16, 0)
    cache = _normal((b, s_max, kv, hd), torch.bfloat16, 1)
    torch.testing.assert_close(A.mha(q, cache[:, :s], cache[:, :s]),
                               A.mha(q, cache[:, :s].contiguous(), cache[:, :s].contiguous()), rtol=0, atol=0)
    qd = _normal((b, h, hd), torch.float32, 2)
    kc, vc = _normal((b, s_max, kv, hd), torch.float32, 3), _normal((b, s_max, kv, hd), torch.float32, 4)
    out1 = DK.flash_decode(qd, kc, vc, 300)[0]
    kc[:, 300:], vc[:, 300:] = 99.0, -99.0
    torch.testing.assert_close(DK.flash_decode(qd, kc, vc, 300)[0], out1, rtol=1e-6, atol=1e-7)
    out, m, l = DK.flash_decode(qd, kc, vc, 0)
    assert not out.any() and bool((m == -1e30).all()) and not l.any()


@needs_card
def test_cuda_attention_wrappers_refuse_what_the_kernels_do_not_take():
    from repro_torch.kernels.attention import kernel as AK
    from repro_torch.kernels.decode import kernel as DK

    q, k = _normal((1, 64, 4, 64), torch.bfloat16, 0), _normal((1, 64, 2, 64), torch.bfloat16, 1)
    with pytest.raises(TypeError):
        AK.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(TypeError):
        AK.flash_attention(q, k.float(), k)
    with pytest.raises(ValueError, match="head dim"):
        AK.flash_attention(q[..., :12].contiguous(), k[..., :12].contiguous(), k[..., :12].contiguous())
    with pytest.raises(ValueError, match="contiguous last dimension"):
        AK.flash_attention(_normal((1, 64, 64, 4), torch.bfloat16, 7).transpose(2, 3), k, k)
    wide = _normal((1, 64, 4, 72), torch.bfloat16, 2)
    with pytest.raises(ValueError, match="16-byte"):
        AK.flash_attention(wide[..., 1:65], k, k)
    with pytest.raises(ValueError, match="shapes"):
        AK.flash_attention(q, k[:, :32], k[:, :32])
    qd = _normal((1, 4, 64), torch.bfloat16, 3)
    with pytest.raises(ValueError, match="head dim"):
        DK.flash_decode(_normal((1, 4, 200), torch.bfloat16, 4), *(2 * [_normal((1, 64, 2, 200), torch.bfloat16, 5)]), 8)
    with pytest.raises(ValueError, match="head dim"):
        AK.flash_attention(*(3 * [_normal((1, 64, 2, 200), torch.bfloat16, 5)]))
    with pytest.raises(ValueError, match="shapes"):  # k/v shorter than q
        AK.flash_attention(q, k[:, :32], k[:, :32], 30.0)
    with pytest.raises(ValueError, match="softcap"):
        AK.flash_attention(q, k, k, -1.0)
    with pytest.raises(ValueError, match="softcap"):
        DK.flash_decode(qd, k, k, 8, -1.0)
    with pytest.raises(ValueError, match="length"):
        DK.flash_decode(qd, k, k, 65)
    with pytest.raises(ValueError, match="contiguous"):
        DK.flash_decode(_normal((1, 64, 4), torch.bfloat16, 6).transpose(1, 2), k, k, 8)
    with pytest.raises(TypeError):
        DK.flash_decode(qd.float(), k, k, 8)


# the bf16 tensor-core attention kernel over its cases: hd (64- and
# 128-wide instances, zero-filled columns), ragged S around the 128-row
# tile, and q heads per kv head
TC_HDS = [32, 64, 72, 128]
TC_LENGTHS = [1, 63, 64, 65, 300, 1000, 2048]
TC_GROUPS = [1, 3, 4]


@needs_card
@pytest.mark.parametrize("g", TC_GROUPS)
@pytest.mark.parametrize("s", TC_LENGTHS)
@pytest.mark.parametrize("hd", TC_HDS)
def test_cuda_bf16_attention_matches_plain_version(hd, s, g):
    from repro_torch.kernels.attention import kernel as AK, ref as AR

    b, kv = (2, 2) if s <= 300 else (1, 2)
    q = _normal((b, s, kv * g, hd), torch.bfloat16, 0)
    k, v = _normal((b, s, kv, hd), torch.bfloat16, 1), _normal((b, s, kv, hd), torch.bfloat16, 2)
    got = AK.flash_attention(q, k, v)
    torch.testing.assert_close(got.float(), AR.mha_ref(q, k, v).float(), rtol=2e-2, atol=2e-2)


@needs_card
@pytest.mark.parametrize("hd", [64, 128])
def test_cuda_bf16_attention_reads_strided_views(hd):
    """q, k and v as slices of one fused [B, S, H + 2 Kv, hd] buffer, as a
    head-major [B, H, S, hd] tensor seen as [B, S, H, hd], and as
    ``cache[:, :s]`` views of a [B, S_max, Kv, hd] cache: each gives what
    contiguous copies give."""
    from repro_torch.kernels.attention import kernel as AK, ref as AR

    b, s, h, kv, s_max = 2, 333, 6, 2, 700
    fused = _normal((b, s, h + 2 * kv, hd), torch.bfloat16, 0)
    q, k, v = fused[:, :, :h], fused[:, :, h:h + kv], fused[:, :, h + kv:]
    want = AR.mha_ref(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(AK.flash_attention(q, k, v).float(), want.float(), rtol=2e-2, atol=2e-2)
    qt = _normal((b, h, s, hd), torch.bfloat16, 1).transpose(1, 2)
    kt, vt = (_normal((b, kv, s, hd), torch.bfloat16, i).transpose(1, 2) for i in (2, 3))
    want = AR.mha_ref(qt.contiguous(), kt.contiguous(), vt.contiguous())
    torch.testing.assert_close(AK.flash_attention(qt, kt, vt).float(), want.float(), rtol=2e-2, atol=2e-2)
    kc, vc = _normal((b, s_max, kv, hd), torch.bfloat16, 4), _normal((b, s_max, kv, hd), torch.bfloat16, 5)
    q = _normal((b, s, h, hd), torch.bfloat16, 6)
    want = AR.mha_ref(q, kc[:, :s].contiguous(), vc[:, :s].contiguous())
    torch.testing.assert_close(AK.flash_attention(q, kc[:, :s], vc[:, :s]).float(), want.float(),
                               rtol=2e-2, atol=2e-2)


# flash decode over lengths around its 64-position tile and split edges,
# and q heads per kv head
DECODE_LENGTHS = [0, 1, 63, 64, 65, 700, 2176]
DECODE_GROUPS = [1, 3, 4, 8]


@needs_card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", DECODE_GROUPS)
@pytest.mark.parametrize("length", DECODE_LENGTHS)
def test_cuda_flash_decode_lengths_and_groups(length, g, dtype):
    from repro_torch.kernels.decode import kernel as DK, ref as DR

    torch.backends.cuda.matmul.allow_tf32 = False
    b, kv, hd, s_max = 2, 2, 128, 2176
    q = _normal((b, kv * g, hd), dtype, 0)
    kc, vc = _normal((b, s_max, kv, hd), dtype, 1), _normal((b, s_max, kv, hd), dtype, 2)
    out, m, l = DK.flash_decode(q, kc, vc, length)
    want = DR.decode_attention_ref(q, kc, vc, length)
    tol = DECODE_TOLS[dtype]
    torch.testing.assert_close(out.float(), want[0].float(), rtol=tol, atol=tol)
    torch.testing.assert_close(m, want[1], rtol=tol, atol=tol)
    torch.testing.assert_close(l, want[2], rtol=tol, atol=tol)
    if length == 0:
        assert not out.any() and bool((m == -1e30).all()) and not l.any()


# soft cap (grok-1's 30, and 2, which bends every logit), q rows at a
# cache offset (k/v longer than q; offsets on and off the 128-row tile),
# and head widths past 128 (zamba2's 80, hd 136, nemotron-4's 192), both
# dtypes, against the plain versions
OFFSET_CASES = [(2, 200, 0, 4, 2, 128), (2, 200, 1, 6, 2, 128), (2, 200, 127, 6, 2, 64),
                (1, 300, 128, 4, 1, 128), (1, 1024, 1000, 4, 2, 128), (2, 65, 300, 4, 4, 80),
                (2, 333, 67, 6, 2, 192), (1, 130, 1000, 8, 1, 192), (2, 64, 0, 4, 2, 136)]


@needs_card
@pytest.mark.parametrize("softcap", [0.0, 30.0, 2.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,offset,h,kv,hd", OFFSET_CASES)
def test_cuda_flash_attention_cap_offset_and_wide_heads(b, s, offset, h, kv, hd, dtype, softcap):
    from repro_torch.kernels.attention import kernel as AK, ref as AR

    torch.backends.cuda.matmul.allow_tf32 = False
    q = 3.0 * _normal((b, s, h, hd), dtype, 0)
    kc, vc = _normal((b, s + offset + 9, kv, hd), dtype, 1), _normal((b, s + offset + 9, kv, hd), dtype, 2)
    k, v = kc[:, :s + offset], vc[:, :s + offset]  # cache[:, :index + S] views
    before = AK.launches["flash_attention"]
    got = AK.flash_attention(q, k, v, softcap)
    torch.cuda.synchronize()
    assert AK.launches["flash_attention"] == before + 1
    tol = ATTN_TOLS[dtype]
    want = AR.mha_ref(q, k.contiguous(), v.contiguous(), softcap)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@needs_card
@pytest.mark.parametrize("softcap", [0.0, 30.0, 2.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,hd,s,length", [(2, 4, 2, 64, 1024, 700), (8, 48, 8, 128, 2176, 2049),
                                                (2, 16, 2, 192, 2176, 1000), (2, 12, 1, 192, 300, 257),
                                                (8, 96, 8, 192, 2080, 2049), (2, 32, 32, 80, 700, 333)])
def test_cuda_flash_decode_cap_and_wide_heads(b, h, kv, hd, s, length, dtype, softcap):
    from repro_torch.kernels.decode import kernel as DK, ref as DR

    torch.backends.cuda.matmul.allow_tf32 = False
    q = 3.0 * _normal((b, h, hd), dtype, 0)
    kc, vc = _normal((b, s, kv, hd), dtype, 1), _normal((b, s, kv, hd), dtype, 2)
    out, m, l = DK.flash_decode(q, kc, vc, length, softcap)
    want = DR.decode_attention_ref(q, kc, vc, length, softcap)
    tol = DECODE_TOLS[dtype]
    torch.testing.assert_close(out.float(), want[0].float(), rtol=tol, atol=tol)
    torch.testing.assert_close(m, want[1], rtol=tol, atol=tol)
    torch.testing.assert_close(l, want[2], rtol=tol, atol=tol)


@needs_card
@pytest.mark.parametrize("name", ["qwen3-moe-235b-a22b", "grok-1-314b", "zamba2-2.7b", "xlstm-350m",
                                  "internvl2-2b", "musicgen-medium", "nemotron-4-340b"])
def test_cuda_lm_family_matches_the_cpu_run(name):
    """Each family's smoke config widened to d 256, 4 layers (heads of
    nemotron-4's 192 and zamba2's 80 kept): a 40-token prefill into the
    cache (the prefix first) and 4 teacher-forced steps on the card's
    kernels and on the CPU's plain path, float32, TF32 off; the ssm
    replays its tokens one at a time."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.attention import kernel as AK
    from repro_torch.kernels.decode import kernel as DK
    from repro_torch.models import lm

    torch.backends.cuda.matmul.allow_tf32 = False
    base = get_arch(name)
    cfg = base.smoke().scaled(n_layers=4, d_model=256, head_dim=base.hd if base.hd in (80, 192) else 32,
                              n_heads=4 if base.family != "ssm" else 4, moe_block=64,
                              logit_softcap=base.logit_softcap)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = lm.init_lm(cfg, gen, device="cuda")
    r = torch.Generator().manual_seed(1)
    ids = torch.randint(0, cfg.vocab, (2, 44), generator=r)
    prefix = torch.randn((2, cfg.n_prefix, cfg.d_model), generator=r) if cfg.n_prefix else None
    runs = {}
    for dev in ("cuda", "cpu"):
        p = params if dev == "cuda" else _to(params, "cpu")
        cache = lm.init_cache(cfg, 2, 48 + cfg.n_prefix, device=dev)
        before = (AK.launches["flash_attention"], DK.launches["flash_decode"])
        out = []
        if cfg.family == "ssm":
            for t in range(44):
                logits, cache = lm.decode_step(p, ids[:, t:t + 1].to(dev), cache, cfg)
                out.append(logits.cpu())
        else:
            logits, cache = lm.decode_step(p, ids[:, :40].to(dev), cache, cfg,
                                           prefix_embeds=None if prefix is None else prefix.to(dev))
            out.append(logits.cpu())
            for t in range(40, 44):
                logits, cache = lm.decode_step(p, ids[:, t:t + 1].to(dev), cache, cfg)
                out.append(logits.cpu())
        runs[dev] = (out, AK.launches["flash_attention"] - before[0], DK.launches["flash_decode"] - before[1])
    apps = 0 if cfg.family == "ssm" else (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else cfg.n_layers)
    assert runs["cuda"][1:] == (apps, 4 * apps) and runs["cpu"][1:] == (0, 0)
    for got, want in zip(runs["cuda"][0], runs["cpu"][0]):
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


# the gradient kernels (flash_attention_bwd.cu) and the forward's lse, over
# the grid chip_smoke.py's phase 10a runs: hd 64/80/128/136/192 (80 and 136
# padded into the 128- and 192-wide bf16 instances) x g 1/3/6/12 x
# softcap off/30 x ragged S, both dtypes. A gradient sums up to g * S
# terms, so each tolerance's absolute part is scaled by the largest entry
# of the plain version's result (at least 1): float32 the kernels'
# rtol=2e-4, atol=2e-5; bfloat16 2e-2 (P and dS are rounded to bf16 for
# the tensor cores, as the forward rounds P)
BWD_TOLS = {torch.float32: (2e-4, 2e-5), torch.bfloat16: (2e-2, 2e-2)}
LSE_TOLS = {torch.float32: (2e-4, 2e-5), torch.bfloat16: (1e-3, 1e-3)}


def _bwd_close(got, want, dtype, what):
    rtol, atol = BWD_TOLS[dtype]
    scale = max(1.0, float(want.float().abs().max()))
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol * scale, msg=what)


@needs_card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("s", [37, 1000, 2048])
@pytest.mark.parametrize("g", [1, 3, 6, 12])
@pytest.mark.parametrize("hd", [64, 80, 128, 136, 192])
def test_cuda_flash_attention_lse_and_backward_match_plain_versions(hd, g, s, softcap, dtype):
    from repro_torch.kernels.attention import kernel as AK, ref as AR

    torch.backends.cuda.matmul.allow_tf32 = False
    b, kv = (2 if s < 64 else 1), (2 if g < 6 else 1)
    h = g * kv
    q, k, v, do = (_normal(shape, dtype, i) for i, shape in
                   enumerate(((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd), (b, s, h, hd))))
    q = 3.0 * q  # logits past the cap
    before = dict(AK.launches)
    o, lse = AK.flash_attention(q, k, v, softcap, with_lse=True)
    dq, dk, dv = AK.flash_attention_backward(q, k, v, o, lse, do, softcap)
    torch.cuda.synchronize()
    assert AK.launches["flash_attention"] == before["flash_attention"] + 1
    assert AK.launches["flash_attention_bwd"] == before["flash_attention_bwd"] + AK.BWD_LAUNCHES
    rtol, atol = LSE_TOLS[dtype]
    torch.testing.assert_close(lse, AR.mha_lse_ref(q, k, softcap), rtol=rtol, atol=atol)
    want = AR.mha_backward_ref(q, k, v, o, lse, do, softcap)
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.dtype == dtype and got.shape == w.shape
        _bwd_close(got, w, dtype, f"{name} (B, S, H, Kv, hd, softcap) {(b, s, h, kv, hd, softcap)}")


@needs_card
def test_cuda_flash_attention_backward_matches_plain_version_at_llamas_training_shape():
    """The shape the training step gives the bf16 kernels: llama3.2-3b's
    microbatch of one layer, B 1, S 4,096, 24/8 heads, hd 128."""
    from repro_torch.kernels.attention import kernel as AK, ref as AR

    torch.backends.cuda.matmul.allow_tf32 = False
    dtype, (b, s, h, kv, hd) = torch.bfloat16, (1, 4096, 24, 8, 128)
    q, k, v, do = (_normal(shape, dtype, i) for i, shape in
                   enumerate(((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd), (b, s, h, hd))))
    o, lse = AK.flash_attention(q, k, v, with_lse=True)
    rtol, atol = LSE_TOLS[dtype]
    torch.testing.assert_close(lse, AR.mha_lse_ref(q, k), rtol=rtol, atol=atol)
    for name, got, w in zip(("dq", "dk", "dv"), AK.flash_attention_backward(q, k, v, o, lse, do),
                            AR.mha_backward_ref(q, k, v, o, lse, do)):
        _bwd_close(got, w, dtype, name)


@needs_card
@pytest.mark.parametrize("b,s,h,kv,hd,softcap", [
    (1, 4096, 24, 8, 128, 0.0),  # llama3.2-3b's training shape (wgmma)
    (2, 1000, 6, 2, 128, 30.0),  # ragged S, g = 3, capped (wgmma)
    (2, 1000, 6, 2, 64, 30.0),   # the 64-wide wgmma instance
    (1, 1000, 3, 1, 192, 30.0),  # the 192-wide mma.sync instance
], ids=["training", "ragged-g3-cap", "hd64", "hd192"])
def test_cuda_flash_attention_backward_reruns_give_the_same_bits(b, s, h, kv, hd, softcap):
    """No atomics and no order that depends on scheduling: two calls on the
    same inputs return identical dq, dk and dv (the resume check relies on
    it)."""
    from repro_torch.kernels.attention import kernel as AK

    dtype = torch.bfloat16
    q, k, v, do = (_normal(shape, dtype, i) for i, shape in
                   enumerate(((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd), (b, s, h, hd))))
    o, lse = AK.flash_attention(q, k, v, softcap, with_lse=True)
    first = AK.flash_attention_backward(q, k, v, o, lse, do, softcap)
    second = AK.flash_attention_backward(q, k, v, o, lse, do, softcap)
    torch.cuda.synchronize()
    for name, a, c in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, c), f"{name} differs between two calls on the same inputs"
        assert bool(torch.isfinite(a.float()).all())


@needs_card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_function_gradients_match_autograd_through_the_plain_version(dtype):
    from repro_torch.kernels.attention import kernel as AK, ops as A, ref as AR

    torch.backends.cuda.matmul.allow_tf32 = False
    shapes = ((2, 200, 6, 64), (2, 200, 2, 64), (2, 200, 2, 64))
    leaves = [_normal(shape, dtype, i).requires_grad_() for i, shape in enumerate(shapes)]
    plain = [t.detach().clone().requires_grad_() for t in leaves]
    weight = _normal((2, 200, 6, 64), torch.float32, 9)
    before = dict(AK.launches)
    (A.mha(*leaves, 30.0).float() * weight).sum().backward()
    (AR.mha_ref(*plain, 30.0).float() * weight).sum().backward()
    assert AK.launches["flash_attention"] == before["flash_attention"] + 1
    assert AK.launches["flash_attention_bwd"] == before["flash_attention_bwd"] + AK.BWD_LAUNCHES
    for name, got, want in zip("qkv", leaves, plain):
        _bwd_close(got.grad, want.grad, dtype, f"d{name}")


@needs_card
def test_cuda_serving_mha_passes_no_lse_and_saves_nothing(monkeypatch):
    from repro_torch.kernels.attention import kernel as AK, ops as A

    asked, real = [], AK.flash_attention
    monkeypatch.setattr(AK, "flash_attention", lambda *a, **kw: asked.append(kw.get("with_lse", False)) or real(*a, **kw))
    q, k = _normal((1, 128, 4, 64), torch.bfloat16, 0), _normal((1, 128, 2, 64), torch.bfloat16, 1)
    out = A.mha(q, k, k)
    assert out.grad_fn is None
    with torch.no_grad():  # params that require grad, served under no_grad
        A.mha(q.clone().requires_grad_(), k, k)
    assert asked == [False, False]
    out = A.mha(q.clone().requires_grad_(), k, k)
    assert asked[-1] is True and out.grad_fn is not None


@needs_card
def test_cuda_kernels_without_a_backward_refuse_inputs_that_require_grad():
    from repro_torch.kernels.attention import ops as A
    from repro_torch.kernels.decode import kernel as DK

    qd, kc = _normal((1, 4, 64), torch.bfloat16, 0), _normal((1, 64, 2, 64), torch.bfloat16, 1)
    with pytest.raises(ValueError, match="no backward"):
        DK.flash_decode(qd.clone().requires_grad_(), kc, kc, 8)
    x, y, alpha, w0 = _inputs(300, 54)
    for kernel in (K.igd_fold, K.igd_fold_minibatch):
        with pytest.raises(ValueError, match="no backward"):
            kernel(x, y, alpha, w0.clone().requires_grad_())
    # mha under grad: the gradient reaches q, k and v through the kernels
    q = _normal((1, 64, 4, 64), torch.bfloat16, 2).requires_grad_()
    kv = _normal((1, 64, 2, 64), torch.bfloat16, 3).requires_grad_()
    A.mha(q, kv, kv).float().sum().backward()
    assert q.grad is not None and kv.grad is not None and bool(kv.grad.abs().sum() > 0)
    with pytest.raises(ValueError, match="as long as q"):
        A.mha(q[:, :32], kv, kv)


@needs_card
def test_cuda_train_step_matches_the_cpu_run():
    """One grad_accum=2 IGD-momentum step on llama3.2-3b's smoke config
    (float32, remat): the card's kernels (forward, its recompute and the
    gradient kernels) against the CPU's plain path (rtol = atol = 1e-4)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import igd
    from repro_torch.kernels.attention import kernel as AK
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.optim import IGD

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("llama3.2-3b").smoke()
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (4, 64), generator=torch.Generator().manual_seed(1))
    runs = {}
    for dev in ("cuda", "cpu"):
        opt = IGD(igd.diminishing(0.05, 10.0), momentum=0.9)
        p = _to(params, dev)
        before = dict(AK.launches)
        p, state, metrics = train.make_train_step(cfg, opt, grad_accum=2)(p, opt.init(p), {"tokens": tokens.to(dev)}, 0)
        runs[dev] = (p, state, float(metrics["loss"]), {k: AK.launches[k] - before[k] for k in before})
    # forward and its recompute, then the gradient: each layer, each microbatch
    assert runs["cuda"][3] == {"flash_attention": 2 * 2 * cfg.n_layers, "flash_attention_bwd": 2 * 3 * cfg.n_layers}
    assert runs["cpu"][3] == {"flash_attention": 0, "flash_attention_bwd": 0}
    np.testing.assert_allclose(runs["cuda"][2], runs["cpu"][2], rtol=1e-4, atol=1e-4)
    from repro_torch.core.tree import leaves

    for got, want in zip(leaves(runs["cuda"][:2]), leaves(runs["cpu"][:2])):
        torch.testing.assert_close(got.detach().cpu(), want.detach(), rtol=1e-4, atol=1e-4)


@needs_card
@pytest.mark.parametrize("n", [1, 4, 16])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5), (torch.bfloat16, 2e-2)])
def test_cuda_sharded_flash_decode_is_one_launch_a_shard_and_matches_the_kernel(n, dtype, tol):
    """The length-sharded decode on the card: n slices of one cache, each
    one flash_decode launch (empty slices too), the combine against the
    unsharded kernel and the plain version, lengths inside the first
    shard, on a boundary and full."""
    from repro_torch.dist import collectives
    from repro_torch.kernels.decode import kernel as DK, ref as DR
    from repro_torch.launch.mesh import AbstractMesh

    g = torch.Generator(device="cuda").manual_seed(5)
    b, h, kv, hd, s = 2, 12, 4, 128, 4096
    q = torch.randn((b, h, hd), generator=g, device="cuda").to(dtype)
    kc = torch.randn((b, s, kv, hd), generator=g, device="cuda").to(dtype)
    vc = torch.randn((b, s, kv, hd), generator=g, device="cuda").to(dtype)
    for length in (1, 77, s // n, s):
        before = DK.launches["flash_decode"]
        got = collectives.sharded_flash_decode(q, kc, vc, length, AbstractMesh({"model": n}))
        torch.cuda.synchronize()
        assert DK.launches["flash_decode"] == before + n
        torch.testing.assert_close(got, DK.flash_decode(q, kc, vc, length)[0], rtol=tol, atol=tol)
        torch.testing.assert_close(got, DR.decode_attention_ref(q, kc, vc, length)[0], rtol=tol, atol=tol)


@needs_card
def test_cuda_sharded_train_step_on_a_one_rank_nccl_mesh_is_the_unsharded_step():
    """make_train_step(param_shardings=...) on a (1, 1) mesh of one NCCL
    rank, bit for bit the unsharded step on the card; the attention
    kernels run on the ranks' local tensors (local_map)."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.core import igd
    from repro_torch.core.tree import leaves, tree_map
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels.attention import kernel as AK
    from repro_torch.launch import mesh as mesh_mod, train
    from repro_torch.models import lm
    from repro_torch.optim import IGD

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("llama3.2-3b").smoke().scaled(d_model=256, head_dim=64, dtype="bfloat16")
    g = torch.Generator(device="cuda").manual_seed(6)
    params = lm.init_lm(cfg, g, "cuda")
    tokens = torch.randint(0, cfg.vocab, (4, 64), generator=g, device="cuda")
    opt = IGD(igd.constant(0.05), momentum=0.9)
    plain_p = tree_map(lambda x: x.clone(), params)
    plain_o = opt.init(plain_p)
    mesh_mod.init_world(device="cuda")
    try:
        mesh = mesh_mod.make_host_mesh(1, 1, device="cuda")
        shd.set_activation_ctx(mesh)
        pshard = shd.shardings(shd.param_specs(params, cfg, mesh), mesh)
        sp = shd.distribute(params, pshard)
        so = tuple(shd.distribute(t, pshard) for t in opt.init(params))
        batch = shd.distribute({"tokens": tokens}, shd.shardings(shd.batch_specs(cfg, "train", mesh, 4), mesh))
        before = dict(AK.launches)
        sp, so, sm = train.make_train_step(cfg, opt, grad_accum=2, param_shardings=pshard)(sp, so, batch, 0)
        assert all(AK.launches[k] > before[k] for k in ("flash_attention", "flash_attention_bwd"))
        plain_p, plain_o, pm = train.make_train_step(cfg, opt, grad_accum=2)(plain_p, plain_o, {"tokens": tokens}, 0)
        assert torch.equal(sm["loss"], pm["loss"])
        for a, b in zip(leaves(shd.full(sp)) + leaves(shd.full(so)), leaves(plain_p) + leaves(plain_o)):
            assert torch.equal(a, b)
    finally:
        shd.set_activation_ctx(None)
        dist.destroy_process_group()
