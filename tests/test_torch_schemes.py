"""The port's execution schemes against the JAX package on the CPU: the
UDA extras (NullAggregate, gather_fold, segmented_fold, run_igd), buffered
MRS (core/mrs.py) and the shared-memory simulator (core/parallel.py).

Every random draw the reference makes is replayed into the port
(``_threefry_replay``), so each pair folds the same rows in the same
order; the default draws (``TorchDraws``) are checked statistically, as
the reference's own tests check its streams."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threefry_replay import ThreefryReplay, _Epoch
from repro import tasks as ref_tasks
from repro.core import igd as ref_igd, mrs as ref_mrs, ordering as ref_ordering
from repro.core import parallel as ref_parallel, uda as ref_uda
from repro_torch import convert, tasks
from repro_torch.core import draws, igd, mrs, ordering, parallel, uda
from repro_torch.data import synthetic

torch.set_num_threads(1)

# the reference's engine-run tolerance (tests/test_implementation.py)
RTOL, ATOL = 1e-5, 1e-6
TASKS = {"logreg": ("LogisticRegression", {"mu": 0.01}), "svm": ("SVM", {}), "lsq": ("LeastSquares", {})}


def _table(n=96, d=6, seed=0):
    r = np.random.default_rng(seed)
    x = (r.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)
    y = np.sign(r.normal(size=n)).astype(np.float32)
    return {"x": x, "y": y}


def _both(data):
    return {k: jnp.asarray(v) for k, v in data.items()}, convert.table_from_numpy(data, "cpu")


def _aggs(name, d, step=None):
    cls, kw = TASKS[name]
    step = step or (0.3, 96)
    rt, t = getattr(ref_tasks, cls)(dim=d, **kw), getattr(tasks, cls)(dim=d, **kw)
    mu = kw.get("mu")
    ragg = ref_uda.IGDAggregate(rt, ref_igd.diminishing(*step), ref_igd.make_l1_prox(mu) if mu else ref_igd.identity_prox)
    agg = uda.IGDAggregate(t, igd.diminishing(*step), igd.make_l1_prox(mu) if mu else igd.identity_prox)
    return ragg, agg


def _state(d, step=40, weight=40.0, seed=9):
    w0 = (np.random.default_rng(seed).normal(size=d) * 0.1).astype(np.float32)
    return ref_uda.IGDState(jnp.asarray(w0), jnp.int32(step), jnp.float32(weight)), \
        convert.state_from_numpy(w0, step, weight, "cpu")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# core/uda.py
# ---------------------------------------------------------------------------


def test_null_aggregate_matches_reference():
    """The data-movement strawman folds one checksum a tuple (the first
    column in key order), serially and segmented."""
    rdata, data = _both(_table(64))
    ragg, agg = ref_uda.NullAggregate(), uda.NullAggregate()
    want = ref_uda.fold(ragg, ragg.initialize(jax.random.PRNGKey(0)), rdata)
    s0 = agg.initialize(torch.Generator())
    got = uda.fold(agg, s0, data)
    assert got.dtype == torch.float32 and got.shape == ()
    _close(got, want)
    _close(uda.segmented_fold(agg, s0, data, 4), ref_uda.segmented_fold(ragg, jnp.float32(0), rdata, 4))
    assert agg.terminate(agg.merge(got, got)) == 2 * got


@pytest.mark.parametrize("task", sorted(TASKS))
def test_gather_fold_is_the_fold_over_permuted_rows(task):
    """Bit for bit inside the port, and within the engine tolerance of the
    reference's gather_fold."""
    rdata, data = _both(_table())
    ragg, agg = _aggs(task, 6)
    rs, s = _state(6)
    perm = np.random.default_rng(3).permutation(96)
    got = uda.gather_fold(agg, s, data, torch.tensor(perm))
    plain = uda.fold(agg, s, {k: v[torch.tensor(perm)] for k, v in data.items()})
    assert torch.equal(got.model, plain.model) and int(got.step) == int(plain.step) == 136
    _close(got.model, ref_uda.gather_fold(ragg, rs, rdata, jnp.asarray(perm)).model)


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("task", sorted(TASKS))
def test_segmented_fold_matches_reference(task, k):
    rdata, data = _both(_table())
    ragg, agg = _aggs(task, 6)
    rs, s = _state(6)
    want = ref_uda.segmented_fold(ragg, rs, rdata, k)
    got = uda.segmented_fold(agg, s, data, k)
    _close(got.model, want.model)
    assert int(got.step) == int(want.step) == 40 + 96 // k
    assert float(got.weight) == float(want.weight) == 40.0 + 96
    assert got.step.dtype == torch.int32 and got.weight.dtype == torch.float32


@pytest.mark.parametrize("k", [2, 8])
def test_segmented_fold_keeps_weight_zeroed_lanes_over_50_epochs(k):
    """Re-segmenting a merged state every epoch: the weight grows by n an
    epoch (not x(k+1)), the model stays finite, and the 50-epoch run
    stays with the reference's."""
    rdata, data = _both(_table(64, 4))
    ragg, agg = _aggs("svm", 4, step=(0.2, 64))
    rs, s = _state(4, step=0, weight=0.0)
    seg = jax.jit(lambda st: ref_uda.segmented_fold(ragg, st, rdata, k))
    for epoch in range(1, 51):
        weight = float(s.weight)
        s, rs = uda.segmented_fold(agg, s, data, k), seg(rs)
        assert float(s.weight) == weight + 64 == float(rs.weight)
        assert bool(torch.isfinite(s.model).all())
    _close(s.model, rs.model)
    assert int(s.step) == int(rs.step) == 50 * 64 // k


def test_segmented_fold_refuses_an_uneven_split():
    _, agg = _aggs("svm", 6)
    with pytest.raises(ValueError, match="not divisible"):
        uda.segmented_fold(agg, _state(6)[1], _both(_table(90))[1], 4)


@pytest.mark.parametrize("name,segments", [("clustered", 1), ("shuffle_once", 1), ("shuffle_always", 1),
                                           ("shuffle_always", 4)])
def test_run_igd_matches_reference(name, segments):
    rdata, data = _both(_table())
    ragg, agg = _aggs("logreg", 6)
    ref_pol = {"clustered": ref_ordering.Clustered, "shuffle_once": ref_ordering.ShuffleOnce,
               "shuffle_always": ref_ordering.ShuffleAlways}[name]
    pol = {"clustered": ordering.Clustered, "shuffle_once": ordering.ShuffleOnce,
           "shuffle_always": ordering.ShuffleAlways}[name]
    rtask, task = ragg.task, agg.task
    want = ref_uda.run_igd(ragg, rdata, rng=jax.random.PRNGKey(5), epochs=3, ordering=ref_pol(),
                           loss_fn=rtask.full_loss, num_segments=segments)
    got = uda.run_igd(agg, data, generator=torch.Generator().manual_seed(5), epochs=3, ordering=pol(),
                      draws=ThreefryReplay().stream(5, 96, "cpu"), loss_fn=task.full_loss,
                      num_segments=segments)
    assert got.epochs == want.epochs == 3 and not got.converged
    _close(got.model, want.model)
    np.testing.assert_allclose(got.losses, want.losses, rtol=RTOL, atol=ATOL)
    assert got.shuffle_seconds >= 0.0 and got.gradient_seconds > 0.0


def test_run_igd_stops_on_its_rule_with_default_draws():
    from repro_torch.core import convergence

    _, data = _both(_table())
    _, agg = _aggs("svm", 6)
    res = uda.run_igd(agg, data, generator=torch.Generator().manual_seed(0), epochs=40,
                      ordering=ordering.ShuffleAlways(), loss_fn=agg.task.full_loss,
                      stop=convergence.RelativeLossDrop(1e-2))
    assert res.converged and res.epochs < 40 and len(res.losses) == res.epochs


# ---------------------------------------------------------------------------
# core/mrs.py
# ---------------------------------------------------------------------------


def test_reservoir_step_matches_reference():
    key = jax.random.PRNGKey(11)
    rbuf, buf = {"v": jnp.zeros(4, jnp.int32)}, {"v": torch.zeros(4, dtype=torch.int32)}
    for i in range(12):
        k = jax.random.fold_in(key, i)
        s = int(jax.random.randint(k, (), 0, max(i + 1, 1)))
        rbuf, rdrop = ref_mrs.reservoir_step(rbuf, jnp.int32(i), {"v": jnp.int32(i + 1)}, k)
        buf, drop = mrs.reservoir_step(buf, i, {"v": torch.tensor(i + 1, dtype=torch.int32)}, s)
        assert buf["v"].tolist() == np.asarray(rbuf["v"]).tolist()
        assert int(drop["v"]) == int(rdrop["v"])


@pytest.mark.parametrize("n,b", [(50, 8), (64, 64), (30, 40), (200, 1)])
def test_reservoir_sample_matches_reference(n, b):
    """The one-pass plan equals the reference's tuple-at-a-time scan, also
    with a reservoir larger than the stream (untouched slots stay 0)."""
    key = jax.random.PRNGKey(n + b)
    data = {"v": np.arange(1, n + 1, dtype=np.int32), "x": np.arange(2 * n, dtype=np.float32).reshape(n, 2)}
    rdata, tdata = _both(data)
    want = ref_mrs.reservoir_sample(rdata, b, key)
    got = mrs.reservoir_sample(tdata, b, _Epoch(key, n, "cpu").reservoir())
    for k in data:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_reservoir_plan_equals_reservoir_steps():
    """Port-internal: the whole-epoch plan against n single steps on the
    same draws (dropped rows and final slots)."""
    n, b = 300, 16
    s = draws.TorchDraws().stream(4, n, "cpu").epoch().reservoir()
    dropped, owner = mrs.reservoir_plan(s, b)
    buf = {"v": torch.full((b,), -1, dtype=torch.int64)}
    for i in range(n):
        buf, drop = mrs.reservoir_step(buf, i, {"v": torch.tensor(i)}, s[i])
        assert int(drop["v"]) == int(dropped[i])
    assert torch.equal(buf["v"], owner)


def _bufs(b, d, seed):
    r = np.random.default_rng(seed)
    return {"x": (r.normal(size=(b, d)) / np.sqrt(d)).astype(np.float32),
            "y": np.sign(r.normal(size=b)).astype(np.float32)}


@pytest.mark.parametrize("active", [False, True])
@pytest.mark.parametrize("ratio,b", [(1, 10), (2, 10), (2, 7)])
def test_mrs_epoch_matches_reference(ratio, b, active):
    rdata, data = _both(_table(80))
    ragg, agg = _aggs("logreg", 6)
    rs, s = _state(6)
    (ra, ta), (rb, tb) = _both(_bufs(b, 6, 1)), _both(_bufs(b, 6, 2))
    key = jax.random.PRNGKey(8)
    cfg = ref_mrs.MRSConfig(buffer_size=b, ratio=ratio)
    want, want_a = ref_mrs.mrs_epoch(ragg, rs, rdata, ra, rb, jnp.bool_(active), cfg, key)
    got, got_a = mrs.mrs_epoch(agg, s, data, ta, tb, active, mrs.MRSConfig(b, ratio),
                               _Epoch(key, 80, "cpu").reservoir())
    _close(got.model, want.model)
    assert int(got.step) == int(want.step) == 40 + 80 * (1 + ratio * active)
    for k in ("x", "y"):
        np.testing.assert_array_equal(got_a[k].numpy(), np.asarray(want_a[k]))


def test_run_mrs_matches_reference():
    rdata, data = _both(_table(120))
    ragg, agg = _aggs("svm", 6)
    cfg = ref_mrs.MRSConfig(buffer_size=12, ratio=2)
    want, wl = ref_mrs.run_mrs(ragg, rdata, rng=jax.random.PRNGKey(2), epochs=3, cfg=cfg,
                               loss_fn=ragg.task.full_loss)
    got, gl = mrs.run_mrs(agg, data, generator=torch.Generator().manual_seed(2), epochs=3,
                          cfg=mrs.MRSConfig(12, 2), draws=ThreefryReplay(salt=None).stream(2, 120, "cpu"),
                          loss_fn=agg.task.full_loss)
    _close(got, want)
    np.testing.assert_allclose(gl, wl, rtol=RTOL, atol=ATOL)


def test_mrs_refuses_an_empty_buffer():
    _, data = _both(_table(16))
    _, agg = _aggs("svm", 6)
    with pytest.raises(ValueError, match="at least one row"):
        mrs.mrs_epoch(agg, _state(6)[1], data, data, data, False, mrs.MRSConfig(0), torch.zeros(16, dtype=torch.long))


def test_default_reservoir_is_approximately_uniform():
    """Each of n items lands in the final buffer w.p. B/n (tests/test_mrs.py)."""
    n, b, trials = 64, 16, 400
    counts = np.zeros(n)
    data = {"v": torch.arange(n)}
    for t in range(trials):
        s = draws.TorchDraws().stream(t, n, torch.device("cpu")).epoch().reservoir()
        assert bool(((s >= 0) & (s <= torch.arange(n))).all())
        counts[mrs.reservoir_sample(data, b, s)["v"].numpy()] += 1
    freq, expected = counts / trials, b / n
    sigma = np.sqrt(expected * (1 - expected) / trials)
    assert np.all(np.abs(freq - expected) < 5 * sigma + 0.02), freq


def _clustered(n, d):
    data = synthetic.dense_classification(torch.Generator().manual_seed(0), n, d)
    task = tasks.LogisticRegression(dim=d)
    return data, task, uda.IGDAggregate(task, igd.diminishing(0.5, decay=n))


def test_mrs_beats_subsampling_and_the_clustered_scan():
    """Fig. 10 with the default draws: on clustered data, without any
    shuffle, MRS reaches a lower objective than pure subsampling of the
    same buffer and than the clustered scan, in the same epochs."""
    data, task, agg = _clustered(1000, 20)
    gen = torch.Generator().manual_seed(0)
    _, mrs_losses = mrs.run_mrs(agg, data, generator=gen, epochs=4, cfg=mrs.MRSConfig(100, 1),
                                loss_fn=task.full_loss)
    s = draws.TorchDraws().stream(0, 1000, torch.device("cpu")).epoch().reservoir()
    sub = uda.run_igd(agg, mrs.reservoir_sample(data, 100, s), generator=gen, epochs=4)
    clustered = uda.run_igd(agg, data, generator=gen, epochs=4, loss_fn=task.full_loss)
    assert mrs_losses[-1] < float(task.full_loss(sub.model, data))
    assert mrs_losses[-1] < clustered.losses[-1]


# ---------------------------------------------------------------------------
# core/parallel.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", ["lock", "aig", "nolock"])
@pytest.mark.parametrize("task", ["logreg", "lsq"])
def test_hogwild_fold_matches_reference(task, scheme):
    rdata, data = _both(_table(64))
    ragg, agg = _aggs(task, 6)
    rs, s = _state(6)
    key = jax.random.PRNGKey(13)
    cfg = parallel.SharedMemoryConfig(scheme=scheme, workers=4, lost_update_rate=0.3)
    want = ref_parallel.hogwild_fold(ragg.task, ragg.step_size, rs.model, rdata, key,
                                     ref_parallel.SharedMemoryConfig(scheme, 4, 0.3), prox=ragg.prox)
    versions, keep = parallel.hogwild_draws(_Epoch(key, 64, "cpu"), cfg, 6)
    assert (versions is None) == (scheme == "lock") and (keep is None) == (scheme != "nolock")
    got = parallel.hogwild_fold(agg.task, agg.step_size, s.model, data, cfg, versions, keep, prox=agg.prox)
    _close(got, want)


@pytest.mark.parametrize("scheme", ["lock", "nolock"])
def test_run_shared_memory_matches_reference(scheme):
    rdata, data = _both(_table(64))
    ragg, agg = _aggs("svm", 6)
    want, wl = ref_parallel.run_shared_memory(
        ragg.task, ragg.step_size, rdata, rng=jax.random.PRNGKey(4), epochs=3,
        cfg=ref_parallel.SharedMemoryConfig(scheme, 8), loss_fn=ragg.task.full_loss)
    got, gl = parallel.run_shared_memory(
        agg.task, agg.step_size, data, generator=torch.Generator().manual_seed(4), epochs=3,
        cfg=parallel.SharedMemoryConfig(scheme, 8), draws=ThreefryReplay(salt=7).stream(4, 64, "cpu"),
        loss_fn=agg.task.full_loss)
    _close(got, want)
    np.testing.assert_allclose(gl, wl, rtol=RTOL, atol=ATOL)


def test_default_hogwild_draws_have_their_rates():
    ep = draws.TorchDraws().stream(1, 4000, torch.device("cpu")).epoch()
    v = ep.read_versions(5, 8)
    assert v.shape == (4000, 5) and int(v.min()) == 0 and int(v.max()) == 7
    keep = ep.kept_writes(5, parallel.SharedMemoryConfig("nolock", 8, 0.4).keep_probability())
    assert keep.dtype == torch.bool and abs(float(keep.float().mean()) - 0.65) < 0.02


def _unclustered(n, d):
    data = synthetic.dense_classification(torch.Generator().manual_seed(0), n, d, clustered=False)
    return data, tasks.LogisticRegression(dim=d)


def test_lock_equals_serial_igd():
    data, task = _unclustered(512, 12)
    step = igd.constant(0.1)
    model = task.init_model(torch.Generator())
    out = parallel.hogwild_fold(task, step, model, data, parallel.SharedMemoryConfig("lock", 4))
    serial = uda.fold(uda.IGDAggregate(task, step), convert.state_from_numpy(np.zeros(12), 0, 0.0, "cpu"), data)
    np.testing.assert_allclose(out.numpy(), serial.model.numpy(), rtol=RTOL, atol=ATOL)


def test_all_schemes_converge_and_averaging_is_slower():
    """Fig. 9(A) with the default draws: every shared-memory scheme
    converges; model averaging converges, but not faster than serial."""
    data, task = _unclustered(1024, 12)
    step = igd.diminishing(0.3, decay=1024)
    base = float(task.full_loss(task.init_model(torch.Generator()), data))
    for scheme in ("lock", "aig", "nolock"):
        _, losses = parallel.run_shared_memory(task, step, data, generator=torch.Generator().manual_seed(0),
                                               epochs=4, cfg=parallel.SharedMemoryConfig(scheme, 8),
                                               loss_fn=task.full_loss)
        assert losses[-1] < 0.5 * base, scheme
        assert losses == sorted(losses, reverse=True) or losses[-1] < losses[0]
    agg = uda.IGDAggregate(task, step)
    st0 = agg.initialize(torch.Generator())
    l_avg = float(task.full_loss(agg.terminate(uda.segmented_fold(agg, st0, data, 8)), data))
    l_serial = float(task.full_loss(agg.terminate(uda.fold(agg, st0, data)), data))
    assert l_avg < base and l_serial <= l_avg + 1e-6


# ---------------------------------------------------------------------------
# dict models through the schemes (core/tree.py)
# ---------------------------------------------------------------------------


def _lmf(n=48, seed=3):
    kw = {"n_rows": 6, "n_cols": 5, "rank": 2, "mu": 0.05, "mean_row_degree": 8.0, "mean_col_degree": 9.6}
    r = np.random.default_rng(seed)
    data = {"i": r.integers(0, 6, n).astype(np.int32), "j": r.integers(0, 5, n).astype(np.int32),
            "v": r.normal(size=n).astype(np.float32)}
    # factors at the task's own initial scale (LowRankMF.init_scale = 0.1)
    model = {"R": 0.1 * r.normal(size=(5, 2)).astype(np.float32), "L": 0.1 * r.normal(size=(6, 2)).astype(np.float32)}
    ragg = ref_uda.IGDAggregate(ref_tasks.LowRankMF(**kw), ref_igd.diminishing(0.2, decay=n))
    agg = uda.IGDAggregate(tasks.LowRankMF(**kw), igd.diminishing(0.2, decay=n))
    return ragg, agg, data, model


def _close_tree(got, want):
    assert sorted(got) == sorted(want)
    for k in got:
        _close(got[k], want[k])


@pytest.mark.parametrize("scheme", ["lock", "aig", "nolock"])
def test_hogwild_fold_of_a_dict_model_matches_reference(scheme):
    """The ring holds the raveled factors (L before R, as ravel_pytree
    orders them), so each component gets the reference's draws."""
    ragg, agg, data, model = _lmf()
    rdata, tdata = _both(data)
    key = jax.random.PRNGKey(21)
    cfg = parallel.SharedMemoryConfig(scheme=scheme, workers=4, lost_update_rate=0.3)
    want = ref_parallel.hogwild_fold(ragg.task, ragg.step_size, {k: jnp.asarray(v) for k, v in model.items()},
                                     rdata, key, ref_parallel.SharedMemoryConfig(scheme, 4, 0.3), prox=ragg.prox)
    versions, keep = parallel.hogwild_draws(_Epoch(key, 48, "cpu"), cfg, 22)
    got = parallel.hogwild_fold(agg.task, agg.step_size, convert.model_from_numpy(model, "cpu"), tdata, cfg,
                                versions, keep, prox=agg.prox)
    _close_tree(got, want)


def _hogwild_dense(task, step_size, model, examples, cfg, versions=None, keep=None, prox=None):
    """The dense-only simulator as it was before models became trees."""
    prox = prox or igd.identity_prox
    p, d = cfg.workers, model.shape[0]
    n = next(iter(examples.values())).shape[0]
    ring = model[None, :].repeat(p, 1)
    cols = torch.arange(d)
    alphas = step_size(torch.arange(n, dtype=torch.int32))
    ptr = 0
    for k in range(n):
        fresh = ring[ptr]
        read = fresh if cfg.scheme == "lock" else ring[(ptr - versions[k]) % p, cols]
        upd = -alphas[k] * task.example_grad(read, {name: v[k] for name, v in examples.items()})
        if cfg.scheme == "nolock":
            upd = torch.where(keep[k], upd, torch.zeros_like(upd))
        ptr = (ptr + 1) % p
        ring[ptr] = prox(fresh + upd, alphas[k])
    return ring[ptr].clone()


@pytest.mark.parametrize("scheme", ["lock", "aig", "nolock"])
def test_hogwild_fold_of_a_dense_model_is_unchanged_bit_for_bit(scheme):
    _, data = _both(_table(64))
    _, agg = _aggs("logreg", 6)
    _, s = _state(6)
    cfg = parallel.SharedMemoryConfig(scheme=scheme, workers=4, lost_update_rate=0.3)
    versions, keep = parallel.hogwild_draws(draws.TorchDraws().stream(2, 64, "cpu").epoch(), cfg, 6)
    got = parallel.hogwild_fold(agg.task, agg.step_size, s.model, data, cfg, versions, keep, prox=agg.prox)
    assert torch.equal(got, _hogwild_dense(agg.task, agg.step_size, s.model, data, cfg, versions, keep, agg.prox))


@pytest.mark.parametrize("active", [False, True])
def test_mrs_epoch_carries_a_dict_model(active):
    ragg, agg, data, model = _lmf(40)
    rdata, tdata = _both(data)
    rs = ref_uda.IGDState({k: jnp.asarray(v) for k, v in model.items()}, jnp.int32(5), jnp.float32(5.0))
    s = convert.state_from_numpy(model, 5, 5.0, "cpu")
    b = 6
    (ra, ta), (rb, tb) = _both({k: v[:b] for k, v in data.items()}), _both({k: v[-b:] for k, v in data.items()})
    key = jax.random.PRNGKey(8)
    want, want_a = ref_mrs.mrs_epoch(ragg, rs, rdata, ra, rb, jnp.bool_(active), ref_mrs.MRSConfig(b, 2), key)
    got, got_a = mrs.mrs_epoch(agg, s, tdata, ta, tb, active, mrs.MRSConfig(b, 2), _Epoch(key, 40, "cpu").reservoir())
    _close_tree(got.model, want.model)
    assert int(got.step) == int(want.step) == 5 + 40 * (1 + 2 * active)
    for k in data:
        np.testing.assert_array_equal(got_a[k].numpy(), np.asarray(want_a[k]))


def test_run_mrs_carries_a_dict_model():
    """CRF's {"E", "T"} (zero initial model) through the MRS epoch loop."""
    key = jax.random.PRNGKey(3)
    from repro.data import synthetic as ref_synthetic

    rdata, tdata = _both(jax.tree.map(np.asarray, ref_synthetic.tagged_sequences(key, 24, 4, 3, 4)))
    ragg = ref_uda.IGDAggregate(ref_tasks.LinearChainCRF(3, 4), ref_igd.diminishing(0.2, decay=24))
    agg = uda.IGDAggregate(tasks.LinearChainCRF(3, 4), igd.diminishing(0.2, decay=24))
    cfg = ref_mrs.MRSConfig(buffer_size=6, ratio=2)
    want, wl = ref_mrs.run_mrs(ragg, rdata, rng=key, epochs=3, cfg=cfg, loss_fn=ragg.task.full_loss)
    got, gl = mrs.run_mrs(agg, tdata, generator=torch.Generator().manual_seed(3), epochs=3, cfg=mrs.MRSConfig(6, 2),
                          draws=ThreefryReplay(salt=None).stream(3, 24, "cpu"), loss_fn=agg.task.full_loss)
    _close_tree(got, want)
    # the loss sums 24 differences log Z - gold of terms near 10: float32
    # leaves ~1e-5 of it whatever the model, so atol is 24 x 10 x 2^-23 x 8
    np.testing.assert_allclose(gl, wl, rtol=RTOL, atol=2e-5)
