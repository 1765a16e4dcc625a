"""Plan execution behind a compiled-plan cache.

The executor is a *driver* over the program compiler
(``repro_torch.engine.program``): a chosen ``Plan`` becomes an
``EpochProgram`` (batch=1), ``build_program`` lowers it to an epoch
callable, and the callable is memoized keyed by (task, task_args, table
signature, plan) beside the objective evaluator. A cache hit builds
nothing: ``trace_count`` and ``loss_trace_count`` count the builds,
which the cache tests pin across repeat queries.

Every random draw of a run (the initial model, permutations, reservoir
draws, hogwild draws) comes from the engine's one
``core.draws.DrawSource``.

The engine runs on one device. ``Engine()`` means the CUDA card and
raises when there is none; ``Engine(device="cpu")`` runs on the CPU. A
query whose in-memory table lies on another device is an error, not a
silent copy. A stored table (``repro_torch.engine.table``) is the one
exception, by design: its chunks stay where the storage layer keeps them
and move to the engine's device as the fold takes them (``source="table"``
plans), or once through ``table.resolve`` for every other plan; the
bytes moved are counted in ``stats["bytes_to_device"]``.

``plan_store`` (optional) is a persistent plan cache — an object with
``load(plan_key, query) -> PlanReport | None`` and ``store(plan_key,
query, report)`` (``repro_torch.engine.serve.PlanStore``). A fresh engine
pointed at a populated store warm-starts: it probes and plans nothing.

Every run is instrumented through ``repro_torch.obs`` with the
reference's names: the ``engine.run``, ``engine.compile``,
``engine.materialize``, ``epoch``, ``engine.kernel`` (a ``cuda_*`` lane
body's epoch) and ``engine.loss`` spans, and the ``engine.compile_s``,
``engine.materialize_s``, ``engine.epoch.shuffle_s``,
``engine.epoch.grad_s``, ``engine.kernel_us_per_epoch`` and
``engine.loss_s`` histograms. The spans that cover device work close
after the syncs the epoch loop already makes; no hook syncs or reads a
device tensor. ``explain_analyze`` is EXPLAIN ANALYZE: the chosen plan
run under the tracer, its walls beside the cost model's prediction.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import obs, timing
from repro_torch.core import convergence, draws as draws_lib, mrs as mrs_lib
from repro_torch.core import uda as uda_lib
from repro_torch.core import ordering as ordering_lib
from repro_torch.core.tracecount import count_build, fresh_counter
from repro_torch.device import resolve_device
from repro_torch.engine import catalog, planner as planner_lib, probes
from repro_torch.engine import program as program_lib, shard as shard_lib, table as table_lib
from repro_torch.engine.query import AnalyticsQuery
from repro_torch.kernels.igd_fused import kernel as igd_kernel
from repro_torch.launch import mesh as mesh_lib

_ORDERINGS = {
    "clustered": ordering_lib.Clustered,
    "shuffle_once": ordering_lib.ShuffleOnce,
    "shuffle_always": ordering_lib.ShuffleAlways,
}


def _fresh_stats() -> Dict[str, int]:
    return {
        "plan_cache_hits": 0,
        "plan_cache_misses": 0,
        "plans_computed": 0,  # planner actually ran (vs memo/disk hit)
        "plan_disk_hits": 0,  # reports loaded from the plan store
        "probe_runs": 0,  # micro-probe calibrations actually measured
        "bytes_to_device": 0,  # stored-table bytes moved to the engine's device
    }


@dataclasses.dataclass
class CompiledPlan:
    """One compiled-plan cache entry: the plan's epoch program and the
    objective evaluator, each with its build counter."""

    program: program_lib.CompiledProgram
    loss_fn: Any
    loss_trace_counter: Dict[str, int]

    @property
    def trace_count(self) -> int:
        return self.program.trace_count

    @property
    def loss_trace_count(self) -> int:
        return self.loss_trace_counter["traces"]


class Engine:
    """The unified analytics engine: query -> plan -> cached execute.

    ``draws`` is the source of every random draw a run makes
    (``core.draws.DrawSource``: the initial model, the shuffle orderings'
    permutations and the MRS and shared-memory schemes' draws); the
    default, ``TorchDraws``, draws from generators seeded with the
    query's seed on the engine's device."""

    def __init__(self, device=None, draws: Optional[draws_lib.DrawSource] = None,
                 plan_store=None):
        self.device = resolve_device(device)
        self.draws = draws or draws_lib.TorchDraws()
        self.plan_store = plan_store
        self._compiled: Dict[Tuple, CompiledPlan] = {}
        # key -> (pinned table columns, report); see explain()
        self._reports: Dict[Tuple, Tuple] = {}
        self._calibrations: Dict[Tuple, probes.Calibration] = {}
        self.stats = _fresh_stats()

    # -- planning ---------------------------------------------------------

    def _check_data(self, query: AnalyticsQuery) -> None:
        if table_lib.is_stored_table(query.data):
            return  # its chunks move to this device as they are read
        for name, col in query.data.items():
            if not isinstance(col, torch.Tensor):
                raise TypeError(f"column {name!r} is not a torch.Tensor")
            if col.device != self.device:
                raise ValueError(
                    f"column {name!r} lies on {col.device}, the engine runs "
                    f"on {self.device}; move the table (repro_torch.convert."
                    "table_from_numpy takes a device)"
                )

    def _aggregate_for(self, query: AnalyticsQuery):
        spec = catalog.get(query.task)
        args = dict(query.task_args)
        if spec.derive_args is not None:
            args.update(spec.derive_args(args, query.n_examples))
        task = spec.make_task(**args)
        agg = uda_lib.IGDAggregate(
            task,
            spec.step_size(query.n_examples),
            prox=spec.prox(task),
        )
        return task, agg

    def explain(self, query: AnalyticsQuery) -> planner_lib.PlanReport:
        """Plan the query; memoized on the live table + query knobs.

        The table component of the key uses column identity (a stored
        table's handle is itself the identity), NOT just shapes: a
        different table of the same shape may have different statistics
        and must be re-planned. The serving hot path — the same table
        queried repeatedly — hits. With a plan store, a report stored by
        an earlier engine is loaded (and its calibration seeds the probe
        cache) instead of probing and planning."""
        self._check_data(query)
        stored = table_lib.is_stored_table(query.data)
        columns = (query.data,) if stored else tuple(query.data.values())
        plan_key = self._query_plan_key(query)
        key = (plan_key, tuple(id(c) for c in columns))
        hit = self._reports.get(key)
        if hit is not None:
            return hit[1]
        report = None
        if self.plan_store is not None:
            report = self.plan_store.load(plan_key, query)
            if report is not None:
                self.stats["plan_disk_hits"] += 1
                # a re-plan against the same table (other epochs, other
                # hints) measures nothing in this engine either
                self._calibrations.setdefault(query.cache_key_fields(), report.calibration)
        if report is None:
            _, agg = self._aggregate_for(query)
            cal = probes.calibrate(
                agg, query.data, device=self.device, cache=self._calibrations,
                key=query.cache_key_fields(), stats=self.stats,
            )
            report = planner_lib.plan(query, cal)
            self.stats["plans_computed"] += 1
            if self.plan_store is not None:
                self.plan_store.store(plan_key, query, report)
        # pin the columns so a live memo entry's ids cannot be recycled
        # for a different table; bound the memo so pins don't accumulate
        while len(self._reports) >= 128:
            self._reports.pop(next(iter(self._reports)))
        self._reports[key] = (columns, report)
        return report

    def _query_plan_key(self, query: AnalyticsQuery) -> Tuple:
        return query.cache_key_fields() + (
            query.epochs,
            query.memory_budget_bytes,
            tuple(sorted(query.hints.items())),
            # plans (and their probed shard placements) are only valid for
            # the device count they were planned on
            mesh_lib.shard_device_count(self.device),
        )

    # -- compiled-plan cache ----------------------------------------------

    def _compile(self, query: AnalyticsQuery, plan: planner_lib.Plan) -> CompiledPlan:
        key = query.cache_key_fields() + (plan,)
        hit = self._compiled.get(key)
        if hit is not None:
            self.stats["plan_cache_hits"] += 1
            return hit
        self.stats["plan_cache_misses"] += 1
        with obs.span("engine.compile", task=query.task, axes=plan.axes()):
            watch = timing.Stopwatch()
            task, agg = self._aggregate_for(query)
            program = program_lib.build_program(
                task, agg, program_lib.EpochProgram(plan=plan), counter=fresh_counter(),
                device=self.device,
            )
            loss_counter = fresh_counter()
            count_build(loss_counter)
            compiled = CompiledPlan(
                program=program,
                loss_fn=lambda model, data: task.full_loss(model, data),
                loss_trace_counter=loss_counter,
            )
            obs.metrics.observe("engine.compile_s", watch.lap())
        self._compiled[key] = compiled
        return compiled

    def cache_info(self) -> Dict[str, int]:
        return dict(self.stats, compiled_plans=len(self._compiled))

    def clear_cache(self) -> None:
        """Forget the compiled plans and the plan memo, and zero the
        stats. The probed calibrations stay, as the reference keeps its
        probe cache apart from the engine's."""
        self._compiled.clear()
        self._reports.clear()
        self.stats = _fresh_stats()

    # -- execution --------------------------------------------------------

    def run(
        self,
        query: AnalyticsQuery,
        *,
        plan: Optional[planner_lib.Plan] = None,
    ) -> "EngineResult":
        """Plan (unless ``plan`` forces one), compile-or-hit, execute."""
        self._check_data(query)
        report = None
        if plan is None:
            report = self.explain(query)
            plan = report.chosen
        with obs.span("engine.run", task=query.task, axes=plan.axes()):
            compiled = self._compile(query, plan)
            if plan.parallelism == "sharded":
                return shard_lib.execute(compiled, query, report, self)
            return _execute(compiled, query, report, self)

    # -- EXPLAIN ANALYZE ---------------------------------------------------

    def explain_analyze(self, query: AnalyticsQuery) -> obs.DriftReport:
        """Run the chosen plan under the span tracer and diff the cost
        model against the walls it actually produced, per composed axis.

        The predicted side re-prices the plan through
        ``planner.cost_components`` at the epoch count the run actually
        executed (a converged run stops early; epoch-count error is
        convergence modeling, not calibration drift). The measured side
        maps the same axes onto the run's walls: ordering <- the
        shuffle/placement wall, parallelism <- the epoch fold wall (the
        implementation axis takes it for a serial singleton plan, whose
        lane body the model prices there), source <- the
        ``engine.materialize`` span, batching <- zero on this
        single-query path. Loss evaluation is excluded from both sides.
        The walls are host time after the epoch loop's syncs, so on the
        card they cover the kernels. The report persists next to the plan
        in the plan store (``load_analysis`` reads it back) and sets the
        ``engine.drift_ratio`` and ``engine.calibration_stale`` gauges."""
        report = self.explain(query)
        plan = report.chosen
        with obs.tracing() as rec:  # restores the caller's tracer state
            res = self.run(query)
        materialize_s = rec.total("engine.materialize")
        attribution = obs.attribution.attribute(rec.spans, root_name="engine.run")
        comps, _ = planner_lib.cost_components(
            plan, query, report.calibration, float(max(res.epochs, 1)),
        )
        impl_axis = plan.parallelism != "sharded" and plan.scheme == "serial"
        rows = (
            obs.AxisCost(
                "ordering", comps["ordering"], res.shuffle_seconds,
                "shuffle/placement wall (EngineResult.shuffle_seconds)",
            ),
            obs.AxisCost(
                "parallelism", comps["parallelism"],
                0.0 if impl_axis else res.gradient_seconds,
                "lane body measured on the implementation axis"
                if impl_axis
                else "epoch fold wall (EngineResult.gradient_seconds)",
            ),
            obs.AxisCost(
                "batching", 0.0, 0.0,
                "single-query run (B=1); fused lanes are priced on the serving path",
            ),
            obs.AxisCost(
                "source", comps["source"], materialize_s,
                "engine.materialize span (Table.resolve)",
            ),
            obs.AxisCost(
                "implementation", comps["implementation"],
                res.gradient_seconds if impl_axis else 0.0,
                f"epoch fold wall of the {plan.implementation} lane body "
                "(EngineResult.gradient_seconds)"
                if impl_axis
                else "lane body measured on the parallelism axis",
            ),
        )
        analysis = obs.DriftReport(
            axes=plan.axes(),
            plan=plan.to_dict(),
            rows=rows,
            epochs_run=res.epochs,
            predicted_total_s=sum(r.predicted_s for r in rows),
            measured_total_s=sum(r.measured_s for r in rows),
            attribution=attribution.to_dict() if attribution is not None else None,
        )
        obs.metrics.set_gauge("engine.drift_ratio", analysis.drift)
        obs.metrics.set_gauge("engine.calibration_stale", 1.0 if analysis.stale else 0.0)
        if self.plan_store is not None:
            self.plan_store.store_analysis(self._query_plan_key(query), query, analysis)
        return analysis

    def load_analysis(self, query: AnalyticsQuery) -> Optional[obs.DriftReport]:
        """The last persisted EXPLAIN ANALYZE for this query's plan key,
        if the store holds one (e.g. written by another process)."""
        if self.plan_store is None:
            return None
        return self.plan_store.load_analysis(self._query_plan_key(query), query)


@dataclasses.dataclass
class EngineResult:
    model: Any
    losses: List[float]
    epochs: int
    converged: bool
    plan: planner_lib.Plan
    report: Optional[planner_lib.PlanReport]
    shuffle_seconds: float
    gradient_seconds: float
    trace_count: int  # builds of this query's epoch callable, cumulative
    loss_trace_count: int = 0  # builds of its objective evaluator
    # fused-IGD kernel launches made by this run's epochs (0 for
    # torch_fold and for CPU runs, which take the plain versions); a
    # fused batch's lanes share their launches
    kernel_launches: int = 0
    batch_size: int = 1  # queries fused into the run that computed this

    def describe(self) -> str:
        loss = f"loss={self.losses[-1]:.6g}" if self.losses else "loss=n/a"
        head = f"{self.epochs} epochs, {loss}, converged={self.converged}"
        body = self.report.describe() if self.report else self.plan.describe()
        return f"{head}\n{body}"


def _execute(
    compiled: CompiledPlan,
    query: AnalyticsQuery,
    report: Optional[planner_lib.PlanReport],
    engine: Engine,
) -> EngineResult:
    program = compiled.program
    plan = program.plan
    agg = program.agg
    device = engine.device
    stored = table_lib.is_stored_table(query.data)
    streaming = plan.source == "table"
    if streaming and not stored:
        raise ValueError(
            "plan.source='table' needs a stored Table (duck-typed: "
            "is_stored_table); got an in-memory table"
        )
    data = query.data
    if stored and not streaming:
        # the plan needs random access: materialize once through resolve
        watch = timing.Stopwatch()
        with obs.span("engine.materialize", task=query.task):
            data = materialize(query.data, device, engine.stats)
        obs.metrics.observe("engine.materialize_s", watch.lap())
    loss_data = None  # a streamed run's objective reads the materialized table

    def full_table():
        nonlocal loss_data
        if loss_data is None:
            loss_data = materialize(query.data, device, engine.stats) if streaming else data
        return loss_data

    n = query.n_examples
    draws = engine.draws.stream(query.seed, n, device)
    ordering = _ORDERINGS[plan.ordering]()
    if query.target_loss is not None:
        stop = lambda losses, epoch: bool(  # noqa: E731
            losses and losses[-1] <= query.target_loss
        )
    elif query.tolerance:
        stop = convergence.RelativeLossDrop(query.tolerance)
    else:
        stop = None

    def eval_loss(state) -> float:
        """One objective evaluation, timed into ``engine.loss_s`` (kept
        out of the epoch walls; the cost model never prices it)."""
        watch = timing.Stopwatch()
        with obs.span("engine.loss"):
            value = float(compiled.loss_fn(agg.terminate(state), full_table()))
        obs.metrics.observe("engine.loss_s", watch.lap())
        return value

    state = uda_lib.initial_state(draws.initial_model(agg.task))
    if plan.scheme == "mrs":
        zero_buf = mrs_lib.zero_buffer(plan.mrs_buffer, data)
        carry = (state, zero_buf, zero_buf, False)
    launches0 = sum(igd_kernel.launches.values())
    losses: List[float] = []
    shuffle_s = 0.0
    grad_s = 0.0
    converged = False
    epoch = 0
    # the kernel lane's epoch gets its own span, closed after the epoch's
    # sync, so drift, SLOs and attribution see the implementation axis
    kernel_impl = plan.implementation if plan.implementation != "torch_fold" else None
    for epoch in range(1, query.epochs + 1):
        with obs.span("epoch", index=epoch):
            watch = timing.Stopwatch()
            if streaming:
                examples = stream_chunks(query.data, device, engine.stats)
            else:
                examples = ordering.order(data, n, epoch, draws.permutation)
            timing.sync(device)
            epoch_shuffle_s = watch.lap()
            epoch_draws = draws.epoch()
            with (obs.span("engine.kernel", implementation=kernel_impl) if kernel_impl
                  else obs.NULL_SPAN):
                if plan.scheme == "mrs":
                    state, buf_a, buf_b, _ = program.epoch_fn(carry, examples, epoch_draws)
                    # swap: the memory worker cycles last epoch's reservoir
                    carry = (state, buf_b, buf_a, True)
                else:
                    state = program.epoch_fn(state, examples, epoch_draws)
                timing.sync(device)
            epoch_grad_s = watch.lap()
        shuffle_s += epoch_shuffle_s
        grad_s += epoch_grad_s
        obs.metrics.observe("engine.epoch.shuffle_s", epoch_shuffle_s)
        obs.metrics.observe("engine.epoch.grad_s", epoch_grad_s)
        if kernel_impl:
            obs.metrics.observe("engine.kernel_us_per_epoch", epoch_grad_s * 1e6)
        # A stop rule needs the per-epoch objective; without one, a single
        # evaluation after the last epoch suffices.
        if stop is not None:
            losses.append(eval_loss(state))
            if stop(losses, epoch):
                converged = True
                break
    if stop is None and epoch:
        losses.append(eval_loss(state))

    return EngineResult(
        model=agg.terminate(state),
        losses=losses,
        epochs=epoch,
        converged=converged,
        plan=plan,
        report=report,
        shuffle_seconds=shuffle_s,
        gradient_seconds=grad_s,
        trace_count=compiled.trace_count,
        loss_trace_count=compiled.loss_trace_count,
        kernel_launches=sum(igd_kernel.launches.values()) - launches0,
    )


def _to_device(chunk, device, stats):
    """A stored table's columns on ``device``, counting the bytes that
    moved; host chunks go without a host sync (the fold that reads them
    is queued behind the copy on the same stream)."""
    out = {}
    for k, v in chunk.items():
        if v.device != device:
            stats["bytes_to_device"] += v.numel() * v.element_size()
            v = v.to(device, non_blocking=True)
        out[k] = v
    return out


def stream_chunks(table, device, stats):
    """The ``source='table'`` epoch stream: the table's chunks in stored
    order, each moved to ``device`` as the fold takes it."""
    for chunk in table.chunks():
        yield _to_device(chunk, device, stats)


def materialize(table, device, stats):
    """A stored table resolved to one column dict on ``device``."""
    return _to_device(table_lib.resolve(table), device, stats)
