"""repro_torch.engine.shard (sharded local SGD: ``launch/mesh.py``,
``dist/data_parallel.py``, the sharded blocks of ``engine/program.py``,
the planner's sharded axis, probe (f), the fused sharded batches) against
repro.engine, on the CPU.

The port's counterparts of tests/test_shard.py, of the sharded cases of
tests/test_program.py (the k=1 matrix, fused heterogeneous epochs under
every ordering, a sharded plan over a stored table) and of
tests/test_implementation.py::test_sharded_pallas_matches_xla. The same
numpy table goes through both engines; the port's engine replays the
reference's threefry streams (``_threefry_replay``), so the shuffle
orderings fold the same rows in the same order and every run starts from
the reference's initial model. Held pairs:

* k = 1 is the port's own singleton run bit for bit, for every ordering
  and lane body (on the CPU the kernel lanes run their plain versions);
* k > 1 is the reference's run within its engine tolerance (rtol 1e-5,
  atol 1e-6), kernel lanes (plain versions here, the reference's Pallas
  kernels in interpret mode) within its kernel tolerance (2e-4/2e-5);
* placements: k = 4 over d = 1, 2 and 4 virtual CPU devices, each held
  to the reference's run over the same d forced host devices (one
  subprocess), since each placement has its own merge tree.

A fixture restores the port's virtual device count after each test, so
a forced count cannot leak into another test of the same worker."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _threefry_replay import ThreefryReplay
from _torch_obs import torch_obs_isolation  # noqa: F401  (autouse: the port's obs state, reset per test)
from repro import engine as ref_engine
from repro.engine import planner as ref_planner, probes as ref_probes, serve as ref_serve
from repro.engine import shard as ref_shard
from repro_torch import convert, engine
from repro_torch.core import uda
from repro_torch.dist import data_parallel as dp
from repro_torch.engine import planner, probes, program, serve, shard
from repro_torch.kernels.igd_fused import kernel as K, ops, ref as R
from repro_torch.launch import mesh, serve as launch_serve

torch.set_num_threads(1)

ORDERINGS = ("clustered", "shuffle_once", "shuffle_always")
IMPLS = {"torch_fold": "xla_fold", "cuda_fused": "pallas_fused", "cuda_minibatch": "pallas_minibatch"}
# the reference's engine-run and kernel tolerances
RTOL, ATOL = 1e-5, 1e-6
KTOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True)
def one_host_device():
    """Every test starts and ends with one virtual CPU device."""
    mesh.force_host_device_count(1)
    yield
    mesh.force_host_device_count(1)


def _table(n=96, d=4, seed=0):
    r = np.random.default_rng(seed)
    x = (r.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)
    y = np.sign(x @ r.normal(size=d) + 0.3 * r.normal(size=n)).astype(np.float32)
    return {"x": x, "y": y}


def _q(data, seed=0, dim=4, **kw):
    kw.setdefault("epochs", 3)
    kw.setdefault("tolerance", 0.0)
    return engine.AnalyticsQuery(task="logreg", data=data, task_args={"dim": dim}, seed=seed, **kw)


def _ref_q(arrays, seed=0, **kw):
    kw.setdefault("epochs", 3)
    kw.setdefault("tolerance", 0.0)
    hints = dict(kw.pop("hints", {}))
    if "implementation" in hints:
        hints["implementation"] = IMPLS[hints["implementation"]]
    return ref_engine.AnalyticsQuery(task="logreg", data={k: jax.numpy.asarray(v) for k, v in arrays.items()},
                                     task_args={"dim": arrays["x"].shape[1]}, seed=seed, hints=hints, **kw)


def _engine():
    return engine.Engine(device="cpu", draws=ThreefryReplay())


def _plan(ordering="clustered", k=1, h=1, d=1, impl="torch_fold"):
    return engine.Plan(ordering, implementation=impl, parallelism="sharded", num_shards=k,
                       merge_period=h, shard_devices=d)


def _ref_plan(ordering="clustered", k=1, h=1, d=1, impl="torch_fold"):
    return ref_engine.Plan(ordering, "serial", implementation=IMPLS[impl], parallelism="sharded",
                           num_shards=k, merge_period=h, shard_devices=d)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or dict(rtol=RTOL, atol=ATOL)))


# -- the k = 1 collapse ---------------------------------------------------------


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("ordering", ORDERINGS)
def test_sharded_k1_bit_identical_to_singleton(ordering, impl):
    """sharded(k=1) reproduces Engine.run exactly — the same draws in the
    same order, the same fold (or the same one-lane launch), no
    compensation at k = 1 — and the reference's k = 1 run within its
    tolerance (the k=1 matrix of tests/test_program.py)."""
    arrays = _table()
    q = _q(convert.table_from_numpy(arrays, "cpu"), seed=7)
    eng = _engine()
    base = eng.run(q, plan=engine.Plan(ordering, implementation=impl))
    sh = eng.run(q, plan=_plan(ordering, k=1, impl=impl))
    assert torch.equal(base.model, sh.model)
    assert base.losses == sh.losses and base.epochs == sh.epochs
    ref = ref_engine.Engine().run(_ref_q(arrays, seed=7), plan=_ref_plan(ordering, k=1, impl=impl))
    _close(sh.model, ref.model, **(KTOL if impl != "torch_fold" else {}))


def test_sharded_k1_bit_identical_with_stop_rule():
    """Block-boundary loss evaluation at H=1 equals the singleton's
    per-epoch evaluation, so early stopping is identical too."""
    q = _q(convert.table_from_numpy(_table(), "cpu"), epochs=8, tolerance=1e-2)
    eng = _engine()
    base = eng.run(q, plan=engine.Plan("shuffle_once"))
    sh = eng.run(q, plan=_plan("shuffle_once", k=1))
    assert torch.equal(base.model, sh.model)
    assert base.losses == sh.losses
    assert base.epochs == sh.epochs and base.converged == sh.converged


# -- k > 1 against the reference -------------------------------------------------


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("ordering", ORDERINGS)
def test_sharded_k4_matches_the_reference(ordering, impl):
    """k = 4, H = 2 over 3 epochs (a full block, then a short one): the
    compensated schedule, the zeroed lane weights, the left-to-right
    merge and the restored weight, as the reference computes them."""
    arrays = _table()
    res = _engine().run(_q(convert.table_from_numpy(arrays, "cpu"), seed=3),
                        plan=_plan(ordering, k=4, h=2, impl=impl))
    ref = ref_engine.Engine().run(_ref_q(arrays, seed=3), plan=_ref_plan(ordering, k=4, h=2, impl=impl))
    assert res.epochs == ref.epochs == 3
    _close(res.model, ref.model, **(KTOL if impl != "torch_fold" else {}))
    np.testing.assert_allclose(res.losses, ref.losses, rtol=RTOL if impl == "torch_fold" else KTOL["rtol"])


def test_sharded_merge_deterministic_and_cached():
    """k > 1 under fixed draws: the same floats across runs, and the
    repeat query builds no block again."""
    q = _q(convert.table_from_numpy(_table(), "cpu"))
    eng = _engine()
    plan = _plan(k=4, h=2)
    r1 = eng.run(q, plan=plan)
    assert r1.trace_count >= 1
    r2 = eng.run(q, plan=plan)
    assert torch.equal(r1.model, r2.model)
    assert r2.trace_count == r1.trace_count, "repeat sharded query rebuilt a block"
    assert eng.stats["plan_cache_hits"] == 1


def test_sharded_matches_segmented_reference():
    """One H=1 clustered sharded epoch == segmented_fold with the
    compensated schedule (the paper's pure-UDA semantics), in both
    packages."""
    arrays = _table()
    data = convert.table_from_numpy(arrays, "cpu")
    res = _engine().run(_q(data, epochs=1), plan=_plan(k=4))
    spec = engine.get("logreg")
    task = spec.make_task(dim=4)
    agg = uda.IGDAggregate(task, shard.compensated_step_size(spec.step_size(96), 4), prox=spec.prox(task))
    st = uda.initial_state(ThreefryReplay().stream(0, 96, "cpu").initial_model(task))
    seg = uda.segmented_fold(agg, st, data, 4)
    torch.testing.assert_close(res.model, seg.model, rtol=1e-6, atol=1e-8)
    ref = ref_engine.Engine().run(_ref_q(arrays, epochs=1), plan=_ref_plan(k=4))
    _close(res.model, ref.model)


def test_compensated_step_size_is_the_references():
    """k * step(k * t) in float32 in the reference's order (the int32
    product, the schedule, the product by k): the reference's alphas bit
    for bit; the identity at k = 1."""
    step = engine.get("logreg").step_size(581_012)
    assert shard.compensated_step_size(step, 1) is step
    t = np.arange(0, 3 * 145_253, 997, dtype=np.int32)
    ref_step = ref_engine.get("logreg").step_size(581_012)
    for k in (2, 4):
        got = shard.compensated_step_size(step, k)(torch.from_numpy(t))
        want = np.asarray(ref_shard.compensated_step_size(ref_step, k)(jax.numpy.asarray(t)))
        assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    agg = uda.IGDAggregate(None, step)
    assert shard.compensated_aggregate(agg, 1) is agg
    assert shard.compensated_aggregate(agg, 4).step_size is not step


def test_sharded_quality():
    """The real sharded path converges (k = 8, H = 2 over 1,024 rows)."""
    arrays = _table(1024, 12, seed=1)
    data = convert.table_from_numpy(arrays, "cpu")
    task = engine.get("logreg").make_task(dim=12)
    base = float(task.full_loss(torch.zeros(12), data))
    res = _engine().run(_q(data, dim=12, epochs=4), plan=_plan("shuffle_once", k=8, h=2))
    assert res.losses[-1] < 0.5 * base


# -- placements over virtual CPU devices ------------------------------------------

_REF_PLACEMENTS = r"""
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax
from repro import engine
assert jax.local_device_count() == 4
r = np.random.default_rng(0)
x = (r.normal(size=(96, 4)) / 2.0).astype(np.float32)
y = np.sign(x @ r.normal(size=4) + 0.3 * r.normal(size=96)).astype(np.float32)
data = {"x": jax.numpy.asarray(x), "y": jax.numpy.asarray(y)}
out = {}
eng = engine.Engine()
for ordering in ("clustered", "shuffle_once", "shuffle_always"):
    for d in (1, 2, 4):
        q = engine.AnalyticsQuery(task="logreg", data=data, task_args={"dim": 4}, epochs=3, tolerance=0.0, seed=5)
        plan = engine.Plan(ordering, "serial", parallelism="sharded", num_shards=4, merge_period=2,
                           shard_devices=d)
        out[f"{ordering}/{d}"] = np.asarray(eng.run(q, plan=plan).model).tolist()
print("PLACEMENTS " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_placements():
    """The reference's k = 4 runs over 1, 2 and 4 forced host devices (one
    subprocess: the XLA flag cannot change once JAX is up)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", _REF_PLACEMENTS], env=env,
                         capture_output=True, text=True, timeout=600)
    line = next((ln for ln in out.stdout.splitlines() if ln.startswith("PLACEMENTS ")), None)
    assert line is not None, (out.stdout[-2000:], out.stderr[-3000:])
    return {k: np.asarray(v, dtype=np.float32) for k, v in json.loads(line[len("PLACEMENTS "):]).items()}


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("ordering", ORDERINGS)
def test_placements_match_the_references_at_the_same_device_count(ordering, d, ref_placements):
    """k = 4 on d virtual CPU devices: each device folds its own k/d
    lanes, then the d partials merge — (l0+l1)+(l2+l3) at d = 2, the
    left fold at d = 1 and 4 — held to the reference's run over d forced
    host devices."""
    mesh.force_host_device_count(4)
    arrays = _table()
    q = _q(convert.table_from_numpy(arrays, "cpu"), seed=5)
    res = _engine().run(q, plan=_plan(ordering, k=4, h=2, d=d))
    np.testing.assert_allclose(res.model.numpy(), ref_placements[f"{ordering}/{d}"], rtol=RTOL, atol=ATOL)


def test_placement_needs_the_devices_it_names():
    """A plan over more devices than exist is refused with the
    reference's wording; the forced count does not outlive the fixture."""
    q = _q(convert.table_from_numpy(_table(), "cpu"))
    with pytest.raises(ValueError, match="requested a 2-device shard mesh but only 1 device"):
        _engine().run(q, plan=_plan(k=4, d=2))
    with pytest.raises(ValueError, match="not divisible"):
        mesh.force_host_device_count(4)
        _engine().run(q, plan=_plan(k=2, d=4))
    with pytest.raises(ValueError):
        mesh.force_host_device_count(0)


def test_mesh_counts_and_devices():
    assert mesh.shard_device_count("cpu") == 1
    assert mesh.force_host_device_count(3) == 3
    assert mesh.shard_device_count("cpu") == 3
    assert mesh.shard_devices(2, "cpu") == [torch.device("cpu")] * 2
    mesh.force_host_device_count(1)
    assert mesh.shard_devices(1, "cpu") == [torch.device("cpu")]


def test_data_parallel_layouts_and_merge_tree():
    """partition_rows is a view and refuses a ragged split; scatter_lanes
    splits lanes by device and copies nothing on one device; the batched
    merge is each query's merge bit for bit; device_merge folds the
    partials left to right."""
    t = {"x": torch.arange(24.0).view(12, 2), "y": torch.arange(12.0)}
    seg = dp.partition_rows(t, 4)
    assert seg["x"].shape == (4, 3, 2) and seg["x"].data_ptr() == t["x"].data_ptr()
    with pytest.raises(ValueError, match="not divisible"):
        dp.partition_rows(t, 5)
    (one,) = dp.scatter_lanes(seg, [torch.device("cpu")])
    assert one["x"] is seg["x"] or one["x"].data_ptr() == seg["x"].data_ptr()
    two = dp.scatter_lanes(seg, [torch.device("cpu")] * 2)
    assert [p["y"].shape for p in two] == [(2, 3), (2, 3)] and torch.equal(two[1]["y"], seg["y"][2:])
    agg = uda.IGDAggregate(None, None)
    g = torch.Generator().manual_seed(0)
    bank = uda.IGDState(torch.randn(4, 3, 5, generator=g), torch.randint(0, 9, (4, 3), dtype=torch.int32,
                                                                         generator=g),
                        torch.rand(4, 3, generator=g) * 10)
    batched = dp.merge_stacked(agg, bank, 4, batched=True)
    for b in range(3):
        one_q = dp.merge_stacked(agg, uda.IGDState(*(v[:, b] for v in bank)), 4)
        assert all(torch.equal(u[b], v) for u, v in zip(batched, one_q))
    parts = [uda.IGDState(*(v[i, 0] for v in bank)) for i in range(4)]
    tree = dp.device_merge(agg, parts)
    left = parts[0]
    for p in parts[1:]:
        left = agg.merge(left, p)
    assert all(torch.equal(u, v) for u, v in zip(tree, left))
    assert dp.device_merge(agg, parts[:1]) is parts[0]


# -- the lane layout of a fused sharded batch --------------------------------------


@pytest.mark.parametrize("name", ["igd_fold", "igd_fold_minibatch"])
def test_lanes_share_segments_by_the_divisor(name):
    """x [S, N, D] under w0 [L, D] with S | L: lane l reads segment
    l // (L / S) — each lane its one-lane call on that segment, bit for
    bit (the plain version here; tests/test_torch_cuda.py on the card)."""
    r = np.random.default_rng(4)
    s, lanes, n, d = 3, 6, 97, 5
    x = torch.from_numpy((r.normal(size=(s, n, d)) / 2).astype(np.float32))
    y = torch.from_numpy(np.sign(r.normal(size=(s, n))).astype(np.float32))
    alpha = torch.from_numpy(r.uniform(0.01, 0.1, size=(lanes, n)).astype(np.float32))
    w0 = torch.from_numpy((0.1 * r.normal(size=(lanes, d))).astype(np.float32))
    assert K.lane_layout(x, y, alpha, w0) == (lanes, n, n) and K.lanes_per_xy(x, w0) == 2
    got = getattr(ops, name)(x, y, alpha, w0, loss="lr")
    for lane in range(lanes):
        assert torch.equal(got[lane], getattr(ops, name)(x[lane // 2], y[lane // 2], alpha[lane], w0[lane],
                                                         loss="lr"))
    with pytest.raises(ValueError, match="lane shapes"):
        K.lane_layout(x[:2], y[:2], alpha[:5], w0[:5])
    plain = R.igd_fold_ref if name == "igd_fold" else R.igd_fold_minibatch_ref
    assert torch.equal(R.lanes_ref(plain, x, y, alpha, w0, loss="lr"), got)


# -- the implementation axis ---------------------------------------------------------


@pytest.mark.parametrize("impl", ["cuda_fused", "cuda_minibatch"])
def test_sharded_kernel_lanes_by_hint(impl):
    """The implementation hint lowers the shard lanes (the reference's
    test_sharded_pallas_matches_xla): cuda_fused agrees with the eager
    lanes at the engine tolerance; cuda_minibatch, a different algorithm,
    with the reference's pallas_minibatch sharded run."""
    arrays = _table()
    data = convert.table_from_numpy(arrays, "cpu")
    # the ordering pinned: the choice among orderings is probe-priced
    hints = {"parallelism": "sharded", "num_shards": 2, "merge_period": 2, "ordering": "shuffle_once"}
    eng = _engine()
    res = eng.run(_q(data, hints=dict(hints, implementation=impl)))
    assert res.plan.parallelism == "sharded" and res.plan.implementation == impl
    if impl == "cuda_fused":
        ref = eng.run(_q(data, hints=dict(hints, implementation="torch_fold")))
        _close(res.model, ref.model.numpy())
    else:
        ref = ref_engine.Engine().run(_ref_q(arrays, hints=dict(hints, implementation=impl)))
        _close(res.model, ref.model, **KTOL)


# -- the planner ------------------------------------------------------------------


def test_planner_single_device_stays_singleton():
    """One CPU device: no probe (f), no sharded candidate unless hinted."""
    rep = _engine().explain(_q(convert.table_from_numpy(_table(128), "cpu")))
    assert rep.chosen.parallelism == "singleton"
    assert not any(c.plan.parallelism == "sharded" for c in rep.candidates)
    assert rep.calibration.shard == {} and rep.calibration.device_count == 1


def test_probe_f_runs_on_virtual_devices_and_plans_sharded_candidates():
    """Two virtual CPU devices: probe (f) measures a sharded point (k = 8
    over the 96-row slab, placed on 1 or 2 devices) and the planner
    enumerates sharded candidates without a hint, each priced from it."""
    mesh.force_host_device_count(2)
    rep = _engine().explain(_q(convert.table_from_numpy(_table(), "cpu")))
    assert rep.calibration.device_count == 2
    (k, point), = rep.calibration.shard.items()
    assert k == 8 and point.devices in (1, 2) and point.epoch_seconds_per_row > 0
    sharded = [c for c in rep.candidates if c.plan.parallelism == "sharded"]
    assert {c.plan.num_shards for c in sharded} == {8}
    assert {c.plan.merge_period for c in sharded} == {1}  # the divisors of 3 epochs
    assert all("mesh-probed" in c.note for c in sharded)


def test_nonconvex_task_caps_sharded_plans():
    """Model averaging of misaligned non-convex factors diverges at high
    shard counts: the planner caps them, on the reference's constants."""
    point = probes.ShardPoint(num_shards=8, devices=2, epoch_seconds_per_row=1e-7, block_seconds=1e-3)
    cal = probes.Calibration(shuffle_per_row=1e-6, fold_per_row=2e-7, merge_seconds=1e-4, probe_rows=256,
                             shard={8: point}, device_count=8)
    ref_point = ref_probes.ShardPoint(num_shards=8, devices=2, epoch_seconds_per_row=1e-7,
                                      block_seconds=1e-3, unroll=8)
    ref_cal = ref_probes.Calibration(shuffle_per_row=1e-6, fold_per_row={1: 2e-7}, merge_seconds=1e-4,
                                     probe_rows=256, shard={8: ref_point}, device_count=8)
    r = np.random.default_rng(0)
    rows = {"i": r.integers(0, 32, 512).astype(np.int32), "j": r.integers(0, 16, 512).astype(np.int32),
            "v": r.normal(size=512).astype(np.float32)}
    lmf_args = {"n_rows": 32, "n_cols": 16, "rank": 4}
    q_lmf = engine.AnalyticsQuery(task="lmf", data=convert.table_from_numpy(rows, "cpu"), task_args=lmf_args,
                                  epochs=4)
    q_cvx = _q(convert.table_from_numpy(_table(512), "cpu"), epochs=4)
    rq_lmf = ref_engine.AnalyticsQuery(task="lmf", data={k: jax.numpy.asarray(v) for k, v in rows.items()},
                                       task_args=lmf_args, epochs=4)
    rq_cvx = _ref_q(_table(512), epochs=4)

    def ks(plans):
        return {p.num_shards for p in plans if p.parallelism == "sharded"}

    assert ks(planner.enumerate_plans(q_cvx, cal)) == ks(ref_planner.enumerate_plans(rq_cvx, 1, ref_cal)) == {8}
    assert ks(planner.enumerate_plans(q_lmf, cal)) == ks(ref_planner.enumerate_plans(rq_lmf, 1, ref_cal)) \
        == {planner.NONCONVEX_SHARD_CAP}
    # each sharded candidate priced as the reference prices it
    want = {(p.ordering, p.num_shards, p.merge_period, p.shard_devices):
            ref_planner.program_cost(p, rq_cvx, ref_cal, 0.0, True).cost_seconds
            for p in ref_planner.enumerate_plans(rq_cvx, 1, ref_cal) if p.parallelism == "sharded"}
    got = {(p.ordering, p.num_shards, p.merge_period, p.shard_devices):
           planner.program_cost(p, q_cvx, cal, 0.0, True).cost_seconds
           for p in planner.enumerate_plans(q_cvx, cal) if p.parallelism == "sharded"}
    assert got.keys() == want.keys() and len(got) == 3  # 3 orderings x H = 1 (the divisors of 4 epochs)
    for key, cost in want.items():
        assert got[key] == pytest.approx(cost, rel=1e-12)


@pytest.mark.parametrize("hints,match", [
    ({"parallelism": "sharded", "num_shards": 2, "merge_period": 0}, "merge_period"),
    ({"parallelism": "sharded", "scheme": "segmented", "num_shards": 2}, "implies scheme='serial'"),
    ({"parallelism": "sharded", "num_shards": 5}, "num_shards hint that divides"),
    ({"parallelism": "sharded", "num_shards": 4, "shard_devices": 3}, "must divide"),
    ({"parallelism": "sharded"}, "probed mesh point"),
])
def test_invalid_sharded_hints_are_rejected(hints, match):
    """The reference's refusals (tests/test_shard.py), each with its
    message, and the reference refuses the same hints."""
    arrays = _table()
    with pytest.raises(ValueError, match=match):
        _engine().explain(_q(convert.table_from_numpy(arrays, "cpu"), hints=hints))
    with pytest.raises(ValueError, match=match):
        ref_engine.Engine().explain(_ref_q(arrays, hints=hints))


def test_forced_plans_are_checked_at_run_time():
    """A forced plan bypasses the planner; execution still refuses
    (merge_period = 0 would loop forever; a ragged split has no layout)."""
    q = _q(convert.table_from_numpy(_table(), "cpu"))
    with pytest.raises(ValueError, match="merge_period"):
        _engine().run(q, plan=_plan(k=2, h=0))
    with pytest.raises(ValueError, match="not divisible"):
        _engine().run(q, plan=_plan(k=5))
    task, agg = _engine()._aggregate_for(q)
    with pytest.raises(ValueError, match="serial fold on each shard"):
        program.build_program(task, agg, program.EpochProgram(
            dataclasses.replace(_plan(k=2), scheme="segmented", num_segments=2)))


def test_hint_forced_sharded_plan_enumerates_and_runs():
    """The planner's choice among the hinted plans is the reference's, and
    the run matches the reference's run of it."""
    arrays = _table()
    hints = {"parallelism": "sharded", "num_shards": 4, "merge_period": 3}
    q = _q(convert.table_from_numpy(arrays, "cpu"), hints=hints)
    eng = _engine()
    rep = eng.explain(q)
    assert rep.chosen.parallelism == "sharded"
    assert rep.chosen.num_shards == 4 and rep.chosen.merge_period == 3
    assert {c.plan.ordering for c in rep.candidates} == set(ORDERINGS) and len(rep.candidates) == 3
    assert "sharded(k=4, H=3, 1 dev)" in rep.describe() and "without a mesh probe" in rep.describe()
    res = eng.run(q)
    assert res.epochs == q.epochs and np.isfinite(res.losses[-1])
    ref = ref_engine.Engine().run(_ref_q(arrays), plan=_ref_plan(rep.chosen.ordering, k=4, h=3))
    _close(res.model, ref.model)


def test_num_shards_hint_alone_adds_sharded_candidates():
    """Without a parallelism hint, num_shards adds the sharded plans next
    to every singleton plan (the reference's enumeration)."""
    arrays = _table()
    hints = {"num_shards": 2}
    rep = _engine().explain(_q(convert.table_from_numpy(arrays, "cpu"), hints=hints))
    ref_rep = ref_engine.Engine().explain(_ref_q(arrays, hints=hints))
    pars = lambda r: sorted((c.plan.parallelism, c.plan.ordering, c.plan.num_shards)  # noqa: E731
                            for c in r.candidates if c.plan.parallelism == "sharded")
    assert pars(rep) == pars(ref_rep) and len(pars(rep)) == 3
    assert any(c.plan.parallelism == "singleton" for c in rep.candidates)


# -- the plan store at format 2 ----------------------------------------------------


def test_plan_json_round_trips_the_shard_fields():
    """Plan, Candidate, PlanReport and Calibration carry the shard fields
    through JSON."""
    point = probes.ShardPoint(num_shards=4, devices=2, epoch_seconds_per_row=3e-7, block_seconds=2e-3)
    cal = probes.Calibration(shuffle_per_row=1e-6, fold_per_row=2e-7, merge_seconds=1e-4, probe_rows=96,
                             shard={4: point}, device_count=2)
    assert probes.Calibration.from_dict(json.loads(json.dumps(cal.to_dict()))) == cal
    plan = _plan("shuffle_always", k=4, h=5, d=2, impl="cuda_fused")
    assert planner.Plan.from_dict(json.loads(json.dumps(plan.to_dict()))) == plan
    cand = planner.Candidate(plan, 0.25, 3.0, "mesh-probed 2.00x/epoch over 2 device(s)")
    assert planner.Candidate.from_dict(json.loads(json.dumps(cand.to_dict()))) == cand
    rep = planner.PlanReport(chosen=plan, cost_seconds=0.25, candidates=(cand,), clusteredness=0.1,
                             calibration=cal, axes=plan.axes())
    back = planner.PlanReport.from_dict(json.loads(json.dumps(rep.to_dict())))
    assert back == rep and back.describe() == rep.describe()


def test_plan_store_format_2_and_a_version_1_entry_is_a_miss(tmp_path):
    q = _q(convert.table_from_numpy(_table(128), "cpu"),
           hints={"parallelism": "sharded", "num_shards": 4, "merge_period": 3})
    store = serve.PlanStore(str(tmp_path))
    first = engine.Engine(device="cpu", plan_store=store)
    rep1 = first.explain(q)
    (path,) = tmp_path.rglob("plan_*.json")
    entry = json.loads(path.read_text())
    assert serve.FORMAT_VERSION == entry["version"] == 2
    assert entry["report"]["chosen"]["parallelism"] == "sharded"
    second = engine.Engine(device="cpu", plan_store=serve.PlanStore(str(tmp_path)))
    rep2 = second.explain(q)
    assert second.stats["plan_disk_hits"] == 1 and second.stats["plans_computed"] == 0
    assert rep2.chosen == rep1.chosen and rep2.describe() == rep1.describe()
    # the same entry as format 1 wrote it (no shard fields): a miss
    entry["version"] = 1
    for k in ("parallelism", "num_shards", "merge_period", "shard_devices"):
        entry["report"]["chosen"].pop(k)
    path.write_text(json.dumps(entry))
    assert store.load(first._query_plan_key(q), q) is None
    third = engine.Engine(device="cpu", plan_store=serve.PlanStore(str(tmp_path)))
    third.explain(q)
    assert third.stats["plan_disk_hits"] == 0 and third.stats["plans_computed"] == 1


def test_fresh_server_warm_starts_a_sharded_plan(tmp_path):
    """Through the launch surface: a fresh server on the same plan store
    serves the sharded batch without planning or probing."""
    mem = convert.table_from_numpy(_table(), "cpu")
    hints = {"parallelism": "sharded", "num_shards": 2, "merge_period": 1, "ordering": "clustered"}
    qs = [_q(mem, seed=s, hints=hints) for s in range(3)]
    for expect_planned in (1, 0):
        srv = launch_serve.make_analytics_server(max_batch=4, device="cpu", cache_dir=str(tmp_path))
        tickets = launch_serve.serve_analytics(qs, server=srv)
        assert all(t.error is None and t.result.plan.parallelism == "sharded" for t in tickets)
        assert srv.engine.stats["plans_computed"] == expect_planned
        assert srv.stats["batches"] == 1
    assert srv.engine.stats["probe_runs"] == 0 and srv.engine.stats["plan_disk_hits"] == 1


# -- serving: fused sharded batches ------------------------------------------------


@pytest.mark.parametrize("impl", ["torch_fold", "cuda_fused"])
@pytest.mark.parametrize("ordering", ORDERINGS)
def test_serve_fused_sharded_heterogeneous_epochs(ordering, impl):
    """Sharded queries over one shared table fuse along a query axis under
    every ordering with heterogeneous budgets (the reference's
    test_sharded_fused_heterogeneous_epochs_all_orderings): ONE batch,
    each lane its own sharded Engine.run and the reference's fused lane."""
    arrays = _table()
    mem = convert.table_from_numpy(arrays, "cpu")
    hints = {"parallelism": "sharded", "num_shards": 2, "merge_period": 2, "ordering": ordering,
             "implementation": impl}
    budgets = (2, 4, 3)
    eng = _engine()
    singles = [eng.run(_q(mem, seed=s, epochs=e, hints=hints)) for s, e in enumerate(budgets)]
    assert singles[0].plan.parallelism == "sharded"
    srv = serve.ServingEngine(serve.ServeConfig(max_batch=4), engine=_engine())
    tickets = [srv.submit(_q(mem, seed=s, epochs=e, hints=hints)) for s, e in enumerate(budgets)]
    srv.drain()
    assert srv.stats["batches"] == 1 and srv.stats["masked_batches"] == 1
    ref_srv = ref_serve.ServingEngine(ref_serve.ServeConfig(max_batch=4))
    ref_data = {k: jax.numpy.asarray(v) for k, v in arrays.items()}  # ONE table for the group
    ref_tickets = [ref_srv.submit(_ref_q(ref_data, seed=s, epochs=e, hints=hints)) for s, e in enumerate(budgets)]
    ref_srv.drain()
    assert ref_srv.stats["batches"] == 1
    tol = dict(rtol=RTOL, atol=ATOL) if impl == "torch_fold" else KTOL
    for t, rt, single in zip(tickets, ref_tickets, singles):
        assert t.error is None and rt.error is None, (t.error, rt.error)
        assert t.result.batch_size == 3 and t.result.epochs == single.epochs
        np.testing.assert_allclose(t.result.model.numpy(), single.model.numpy(), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(t.result.model.numpy(), np.asarray(rt.result.model), **tol)
        np.testing.assert_allclose(t.result.losses[-1], single.losses[-1], rtol=RTOL)


def test_serve_sharded_distinct_tables_fall_back_to_singleton():
    arrays = _table()
    d1 = convert.table_from_numpy(arrays, "cpu")
    d2 = convert.table_from_numpy({k: v * 1.25 for k, v in arrays.items()}, "cpu")
    hints = {"parallelism": "sharded", "num_shards": 2, "merge_period": 1, "ordering": "clustered"}
    srv = serve.ServingEngine(serve.ServeConfig(max_batch=4), engine=_engine())
    t1 = srv.submit(_q(d1, seed=0, hints=hints))
    t2 = srv.submit(_q(d2, seed=1, hints=hints))
    srv.drain()
    assert srv.stats["batches"] == 0 and srv.stats["singleton_queries"] == 2
    assert t1.error is None and t2.error is None
    assert torch.equal(t2.result.model, _engine().run(_q(d2, seed=1, hints=hints)).model)


def test_sharded_plan_on_stored_table_materializes_and_runs():
    """A sharded plan over a stored table resolves it through
    ``table.resolve`` before partitioning, counting the bytes moved."""
    arrays = _table()
    tab = engine.ChunkedTable.from_arrays(convert.table_from_numpy(arrays, "cpu"), 32)
    hints = {"parallelism": "sharded", "num_shards": 2, "merge_period": 1, "ordering": "clustered"}
    eng = _engine()
    res = eng.run(_q(tab, hints=hints))
    ref = eng.run(_q(convert.table_from_numpy(arrays, "cpu"), hints=hints))
    assert res.plan.parallelism == "sharded" and res.plan.source == "memory"
    assert torch.equal(res.model, ref.model)
