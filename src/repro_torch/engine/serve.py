"""repro_torch.engine.serve — the analytics serving front end.

A database serves many concurrent analytics queries, not one script at a
time. This layer models that multi-tenant reality on top of the engine
with three mechanisms, and the telemetry around them:

* **Admission control** (``ServingEngine.submit``): a bounded queue with
  a per-task depth limit. Overload sheds cleanly — a rejected query gets
  an immediate ``Ticket`` with ``accepted=False`` and a reason
  (``queue_full`` / ``task_limit``) instead of unbounded queueing.

* **Cross-query batching** (``ServingEngine.pump``): queued queries that
  share a *fused key* — same ``(task, task_args, table signature)`` (the
  executor's cache key fields) and same chosen plan — are stacked along a
  new query axis and the ENTIRE multi-epoch run executes as one fused
  run, built by the one program compiler
  (``repro_torch.engine.program.build_program``). Queries that differ
  ONLY in their epoch budget still fuse: every fused run takes per-lane
  budgets and keeps a lane's state once its budget is spent (masked-lane
  fusion). Each lane opens its singleton run's draws
  (``core.draws.lane_streams``), so a fused query returns what its
  ``Engine.run`` returns. Kernel lanes (``cuda_fused``/``cuda_minibatch``)
  are ONE lane launch of the fused-IGD kernel an epoch, a block (or a
  cluster) a lane. Sharded plans fuse too, for every ordering: the B
  queries' lanes ride the plan's local-SGD blocks with a query axis
  (``runner.block(..., batch=B)``; for kernel lanes ONE launch of k × B lanes
  a device an epoch over the one partitioned table) — over ONE shared
  table only: queries over distinct tables run singleton. Queries with
  an early-stop rule (``tolerance``/``target_loss``), a memory budget,
  an MRS plan or a stored-table source keep per-query control flow and
  run singleton through ``Engine.run``.

* **Persistent plan cache** (``PlanStore``): the planner's artifacts —
  chosen plan, full EXPLAIN report, micro-probe calibration — persisted
  as one JSON file per plan-cache key. A fresh engine pointed at a
  populated store warm-starts: ``explain`` loads the report and seeds the
  probe cache, so it probes and plans nothing.

* **Operational telemetry** (``repro_torch.obs``, the reference's
  names): admission counters (``serve.accepted``,
  ``serve.shed.queue_full``, ``serve.shed.task_limit``), the
  ``serve.fused_lanes`` counter, per-task ``serve.queue_wait_s.<task>``
  and ``serve.latency_s.<task>`` histograms, the ``serve.queue_depth``
  and ``serve.plan_store_entries`` callback gauges, a ``serve.pump`` span
  a group and the fused path's ``serve.assemble``/``serve.execute`` spans
  with ``serve.assembly_s``/``serve.execute_s`` (closed after the phase
  syncs the pump already makes; ``serve.execute`` carries ``lanes`` and
  ``implementation``: a fused group's kernel lanes are one launch an
  epoch and open no ``engine.kernel`` span, as in the reference). The
  server installs the always-on flight ring (``flight_capacity``) and,
  with ``slo_rules``, an ``obs.SLOMonitor`` evaluated between pump
  groups, whose breaches write incident files under ``incident_dir``
  (default ``<cache_dir>/incidents``). The plan store keeps each plan's
  last EXPLAIN ANALYZE report beside it (``plan_<digest>.analyze.json``).

Typical use::

    from repro_torch.engine import serve

    srv = serve.ServingEngine(serve.ServeConfig(cache_dir=".plan_cache"))
    # only fixed-epoch queries fuse: tolerance=0.0 and no target_loss
    tickets = [srv.submit(q) for q in queries]
    srv.drain()
    for t in tickets:
        print(t.result.describe() if t.accepted else t.reject_reason)
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import obs, timing
from repro_torch.core import draws as draws_lib
from repro_torch.core.tree import tree_map
from repro_torch.engine import executor, planner as planner_lib
from repro_torch.engine import program as program_lib
from repro_torch.engine.query import AnalyticsQuery
from repro_torch.kernels.igd_fused import kernel as igd_kernel
from repro_torch.obs import flight as flight_lib, slo as slo_lib

# The port's own on-disk layout (its own files under the cache dir's
# torch/ directory; the reference's files are never read). Bump when the
# entry layout, or anything the planner persists, changes shape:
# version-mismatched entries read as a miss and are rewritten.
# v1: Plan with the source and implementation axes; Calibration with
# the eager fold's one rate, the segmented points and the kernel lanes.
# v2: Plan grew the parallelism axis (parallelism, num_shards,
# merge_period, shard_devices); Calibration the sharded mesh points
# (shard) and device_count.
FORMAT_VERSION = 2
STORE_DIR = "torch"

# bound on retained fused programs, one per (query key, plan, batch
# size, table sharing, epoch bound): a long-running server seeing many
# burst sizes must not accumulate them unboundedly (FIFO eviction)
MAX_COMPILED_BATCHES = 32

REJECT_QUEUE_FULL = "queue_full"
REJECT_TASK_LIMIT = "task_limit"


# ---------------------------------------------------------------------------
# persistent plan cache
# ---------------------------------------------------------------------------


class PlanStore:
    """On-disk plan cache: ``<root>/torch/plan_<sha256(plan_key)>.json``.

    Each entry holds {version, key repr, table content fingerprint,
    serialized PlanReport (plan + calibrated cost table + full candidate
    ranking)}. Invalidation is structural: a version bump, a key-repr
    mismatch (hash collision / foreign file) or a fingerprint mismatch
    (same-shaped but different table, whose statistics may differ) all
    read as a miss, and the next ``store`` overwrites the entry. Writes
    are atomic (tmp file + rename) so a crashed process never leaves a
    torn entry."""

    def __init__(self, root: str):
        self.root = os.path.join(root, STORE_DIR)
        os.makedirs(self.root, exist_ok=True)

    def size(self) -> int:
        """Live plan-entry count (analysis and tmp files excluded) — the
        ``serve.plan_store_entries`` callback gauge."""
        try:
            names = os.listdir(self.root)
        except OSError:
            return 0
        return sum(1 for n in names if n.startswith("plan_") and n.endswith(".json")
                   and not n.endswith(".analyze.json"))

    def _path(self, plan_key: Tuple) -> str:
        digest = hashlib.sha256(repr(plan_key).encode()).hexdigest()[:32]
        return os.path.join(self.root, f"plan_{digest}.json")

    def _read(self, path: str, plan_key: Tuple, query: AnalyticsQuery) -> Optional[dict]:
        """The entry at ``path``, or None on a miss (absent, torn, another
        version, another key or another table)."""
        try:
            with open(path) as f:
                entry = json.load(f)
        except (OSError, ValueError):
            return None
        if (
            entry.get("version") != FORMAT_VERSION
            or entry.get("key") != repr(plan_key)
            or entry.get("fingerprint") != query.content_fingerprint()
        ):
            return None
        return entry

    def load(self, plan_key: Tuple, query: AnalyticsQuery) -> Optional[planner_lib.PlanReport]:
        entry = self._read(self._path(plan_key), plan_key, query)
        try:
            return None if entry is None else planner_lib.PlanReport.from_dict(entry["report"])
        except (KeyError, TypeError, ValueError):
            return None

    def store(self, plan_key: Tuple, query: AnalyticsQuery,
              report: planner_lib.PlanReport) -> None:
        self._write(self._path(plan_key), plan_key, query, {"report": report.to_dict()})

    # -- EXPLAIN ANALYZE persistence: the drift report lives NEXT TO the
    # plan entry (same digest, its own file), so the last measured run
    # travels with the stored plan and a fresh process can check the
    # calibration's staleness before trusting it.

    def _analysis_path(self, plan_key: Tuple) -> str:
        return self._path(plan_key)[: -len(".json")] + ".analyze.json"

    def load_analysis(self, plan_key: Tuple, query: AnalyticsQuery) -> Optional[obs.DriftReport]:
        entry = self._read(self._analysis_path(plan_key), plan_key, query)
        try:
            return None if entry is None else obs.DriftReport.from_dict(entry["analysis"])
        except (KeyError, TypeError, ValueError):
            return None

    def store_analysis(self, plan_key: Tuple, query: AnalyticsQuery,
                       analysis: obs.DriftReport) -> None:
        self._write(self._analysis_path(plan_key), plan_key, query,
                    {"analysis": analysis.to_dict()})

    def _write(self, path: str, plan_key: Tuple, query: AnalyticsQuery, payload: dict) -> None:
        entry = {
            "version": FORMAT_VERSION,
            "key": repr(plan_key),
            "fingerprint": query.content_fingerprint(),
            **payload,
        }
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(entry, f, indent=1)
            os.replace(tmp, path)
        except OSError:
            # persistence is an optimization: a full/read-only/deleted
            # cache dir must degrade to planning without it, not turn
            # every new-plan-key query into a serving error
            try:
                os.unlink(tmp)
            except OSError:
                pass


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_queue: int = 64  # bounded admission queue (total queued queries)
    max_per_task: int = 32  # per-task queue-depth limit
    max_batch: int = 8  # queries fused into one run
    cache_dir: Optional[str] = None  # persistent plan cache root
    # always-on flight recorder: the server installs a ring of this many
    # completed spans (0 opts out), dumped into every SLO incident file
    flight_capacity: int = 256
    # declarative SLOs (a tuple of obs.SLORule; None = unmonitored),
    # evaluated between pump groups at slo_interval_s cadence; breaches
    # dump the flight ring to incident_dir (default:
    # <cache_dir>/incidents when a cache_dir is configured)
    slo_rules: Optional[Tuple] = None
    slo_interval_s: float = 1.0
    incident_dir: Optional[str] = None


_UNSET = object()  # sentinel: a ticket's batch key may legitimately be None


@dataclasses.dataclass(eq=False)  # identity eq: the queue removes by ticket
class Ticket:
    """One submitted query's handle: admission verdict, then the result."""

    query: AnalyticsQuery
    accepted: bool
    reject_reason: Optional[str] = None
    submit_s: float = 0.0
    done_s: Optional[float] = None
    result: Optional[executor.EngineResult] = None
    # a query that failed planning/execution completes with the error
    # recorded instead of killing the server loop (result stays None)
    error: Optional[str] = None
    # pump() memoizes the fused key here so a ticket is planned at most
    # once while queued
    batch_key_cache: Any = _UNSET

    @property
    def done(self) -> bool:
        return self.done_s is not None

    @property
    def latency_s(self) -> Optional[float]:
        """Queue wait + execution (submit -> completion)."""
        return None if self.done_s is None else self.done_s - self.submit_s


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------


class ServingEngine:
    """Admission control + cross-query batching over one ``Engine``.

    Single-pump execution model: ``submit`` only enqueues (admission is
    O(1) and never blocks on planning); ``pump`` takes the queue head,
    fuses every compatible queued query with it (up to ``max_batch``),
    and executes the group — so "concurrency" is the fused batch, which
    is the honest model on a single card. ``drain`` pumps until the
    queue is empty. ``engine`` defaults to ``Engine()`` on the card; pass
    ``executor.Engine(device="cpu")`` to serve on the CPU."""

    def __init__(self, config: ServeConfig = ServeConfig(),
                 engine: Optional[executor.Engine] = None):
        store = PlanStore(config.cache_dir) if config.cache_dir else None
        if engine is None:
            engine = executor.Engine(plan_store=store)
        elif store is not None and engine.plan_store is None:
            # an explicitly passed engine still honors the cache_dir knob
            engine.plan_store = store
        self.engine = engine
        self.config = config
        self._queue: collections.deque = collections.deque()
        self._queued_per_task: collections.Counter = collections.Counter()
        self._batched: Dict[Tuple, program_lib.CompiledProgram] = {}
        # operational telemetry: the always-on flight ring, the live
        # queue-depth / plan-store-size callback gauges (a snapshot or a
        # /metrics scrape reads them without calling into the engine),
        # and the SLO monitor pump() evaluates on its cadence
        if config.flight_capacity:
            flight_lib.enable(config.flight_capacity)
        obs.metrics.gauge("serve.queue_depth", fn=lambda: len(self._queue))
        if self.engine.plan_store is not None and hasattr(self.engine.plan_store, "size"):
            obs.metrics.gauge("serve.plan_store_entries", fn=self.engine.plan_store.size)
        self.slo: Optional[slo_lib.SLOMonitor] = None
        if config.slo_rules:
            incident_dir = config.incident_dir
            if incident_dir is None and config.cache_dir:
                incident_dir = os.path.join(config.cache_dir, "incidents")
            self.slo = slo_lib.SLOMonitor(config.slo_rules, interval_s=config.slo_interval_s,
                                          incident_dir=incident_dir)
        self.stats = {
            "accepted": 0,
            "rejected": 0,
            "shed_queue_full": 0,  # rejected: total queue bound
            "shed_task_limit": 0,  # rejected: per-task depth limit
            "batches": 0,
            "batched_queries": 0,
            "fused_lanes": 0,  # lanes that rode a fused (batch > 1) run
            "masked_batches": 0,  # fused groups with heterogeneous epochs
            "singleton_queries": 0,
            "failed_queries": 0,
        }

    # -- admission --------------------------------------------------------

    def submit(self, query: AnalyticsQuery) -> Ticket:
        now = timing.now()
        if len(self._queue) >= self.config.max_queue:
            self.stats["rejected"] += 1
            self.stats["shed_queue_full"] += 1
            obs.metrics.inc("serve.shed.queue_full")
            return Ticket(query, False, REJECT_QUEUE_FULL, submit_s=now)
        if self._queued_per_task[query.task] >= self.config.max_per_task:
            self.stats["rejected"] += 1
            self.stats["shed_task_limit"] += 1
            obs.metrics.inc("serve.shed.task_limit")
            return Ticket(query, False, REJECT_TASK_LIMIT, submit_s=now)
        ticket = Ticket(query, True, submit_s=now)
        self._queue.append(ticket)
        self._queued_per_task[query.task] += 1
        self.stats["accepted"] += 1
        obs.metrics.inc("serve.accepted")
        return ticket

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    # -- batching ---------------------------------------------------------

    def _batch_key(self, query: AnalyticsQuery) -> Optional[Tuple]:
        """The fused key, or None when the query must run solo.

        Early-stop queries (tolerance / target_loss) need per-query stop
        rules; a memory budget bounds ONE query's footprint, which
        stacking would multiply; MRS plans carry per-query reservoirs;
        stored tables are a chunk stream, not a stackable table. All keep
        the singleton path (which also serves them from the compiled-plan
        cache). ``epochs`` is NOT part of the key: queries that differ
        only in their epoch budget fuse via per-lane masks."""
        if query.target_loss is not None or query.tolerance or query.epochs < 1:
            return None
        if query.memory_budget_bytes is not None:
            return None
        try:
            plan = self.engine.explain(query).chosen
        except Exception:  # noqa: BLE001 — unplannable: the singleton path reports it
            return None
        if not planner_lib.batchable(query, plan):
            return None
        return (query.cache_key_fields(), plan)

    def _ticket_key(self, ticket: Ticket) -> Optional[Tuple]:
        if ticket.batch_key_cache is _UNSET:
            ticket.batch_key_cache = self._batch_key(ticket.query)
        return ticket.batch_key_cache

    def pump(self) -> int:
        """Serve the queue head (plus everything batchable with it).
        Returns the number of queries completed."""
        if not self._queue:
            return 0
        head = self._queue.popleft()
        self._queued_per_task[head.query.task] -= 1
        group = [head]
        key = self._ticket_key(head)
        if key is not None and self.config.max_batch > 1:
            # stop scanning once the batch is full, and never force
            # planning (probes) on a ticket whose cheap key prefix already
            # rules fusion out
            matches = []
            for t in self._queue:
                if len(matches) >= self.config.max_batch - 1:
                    break
                if t.query.cache_key_fields() != key[0]:
                    continue
                if self._ticket_key(t) == key:
                    matches.append(t)
            for t in matches:
                self._queue.remove(t)
                self._queued_per_task[t.query.task] -= 1
            group.extend(matches)
        dequeued = timing.now()
        for t in group:
            obs.metrics.observe(f"serve.queue_wait_s.{t.query.task}", dequeued - t.submit_s)
        # the group span is what tail-latency attribution decomposes:
        # admission wait is not a span, so the pump stamps the group's
        # worst wait as an attribute for the queue_wait phase
        max_wait = max(dequeued - t.submit_s for t in group)

        # one bad query must not take the server loop (or the rest of the
        # queue) down with it: failures complete the ticket with an error
        with obs.span("serve.pump", batch=len(group), queue_wait_s=max_wait):
            try:
                if len(group) == 1:
                    head.result = self.engine.run(head.query)
                    head.done_s = timing.now()
                    self.stats["singleton_queries"] += 1
                elif self._run_batch(group, key[1]):
                    self.stats["batches"] += 1
                    self.stats["batched_queries"] += len(group)
                    self.stats["fused_lanes"] += len(group)
                    obs.metrics.inc("serve.fused_lanes", len(group))
                    if len({t.query.epochs for t in group}) > 1:
                        self.stats["masked_batches"] += 1
                else:
                    # the group declined fusion at run time (a sharded plan
                    # over distinct tables): served singleton, still done
                    self.stats["singleton_queries"] += len(group)
            except Exception as e:  # noqa: BLE001 — record on the tickets, keep serving
                now = timing.now()
                errored = 0
                for t in group:
                    if t.done_s is None:
                        t.error = f"{type(e).__name__}: {e}"
                        t.done_s = now
                        errored += 1
                self.stats["failed_queries"] += errored
                # tickets already served (the sharded distinct-table fallback
                # completes them one by one) are successes, not casualties
                self.stats["singleton_queries"] += len(group) - errored
        for t in group:
            if t.done_s is not None and t.error is None:
                obs.metrics.observe(f"serve.latency_s.{t.query.task}", t.done_s - t.submit_s)
        # SLO cadence: between groups, never mid-batch — monitoring must
        # not sit inside the fused run's wall
        if self.slo is not None:
            self.slo.maybe_evaluate()
        return len(group)

    def drain(self) -> int:
        """Pump until the queue is empty; returns queries completed."""
        total = 0
        while True:
            done = self.pump()
            if not done:
                return total
            total += done

    # -- batched execution ------------------------------------------------

    def _timed_phases(self, assemble, execute, *, lanes: int,
                      implementation: str) -> Tuple[Any, Any, float, float]:
        """One timing discipline for both fused paths: run ``assemble``
        (input staging — stacking, permutations, placement) then
        ``execute`` (the fused epochs), each under its obs span and timed
        on the host clock after a wait for the device
        (``timing.Stopwatch`` + ``timing.sync``), into the
        ``serve.assembly_s``/``serve.execute_s`` histograms. ``lanes``
        (the queries, times the shards of a sharded plan) and the
        ``implementation`` ride on the ``serve.execute`` span. Returns
        ``(assembled, executed, assemble_s, execute_s)``."""
        device = self.engine.device
        watch = timing.Stopwatch()
        with obs.span("serve.assemble"):
            assembled = assemble()
            timing.sync(device)
        assemble_s = watch.lap()
        with obs.span("serve.execute", lanes=lanes, implementation=implementation):
            executed = execute(assembled)
            timing.sync(device)
        execute_s = watch.lap()
        obs.metrics.observe("serve.assembly_s", assemble_s)
        obs.metrics.observe("serve.execute_s", execute_s)
        return assembled, executed, assemble_s, execute_s

    def _finish_group(self, tickets: List[Ticket], models, losses, plan: planner_lib.Plan, *,
                      shuffle_s: float, grad_s: float, trace_count: int,
                      kernel_launches: int) -> None:
        """Per-ticket completion: slice lane ``i`` out of the stacked
        models/losses and stamp an ``EngineResult`` whose walls are
        amortized over the batch (the whole group paid them once)."""
        b = len(tickets)
        losses = losses.cpu().tolist()  # the group's one read back to the host
        done = timing.now()
        for i, t in enumerate(tickets):
            t.result = executor.EngineResult(
                model=tree_map(lambda x: x[i], models),
                losses=[float(losses[i])],
                epochs=t.query.epochs,
                converged=False,
                plan=plan,
                report=None,
                shuffle_seconds=shuffle_s / b,
                gradient_seconds=grad_s / b,
                trace_count=trace_count,
                kernel_launches=kernel_launches,
                batch_size=b,
            )
            t.done_s = done

    def _batched_put(self, key: Tuple, compiled: program_lib.CompiledProgram) -> None:
        """Cache a fused program; the bounded cache evicts first-in
        first-out."""
        while len(self._batched) >= MAX_COMPILED_BATCHES:
            self._batched.pop(next(iter(self._batched)))
        self._batched[key] = compiled

    def _batched_compile(self, query: AnalyticsQuery, plan: planner_lib.Plan, batch: int,
                         shared_table: bool, epochs: int) -> program_lib.CompiledProgram:
        """Build (or fetch) the fused program for this group shape (a
        singleton-parallelism plan: a sharded group's blocks come from
        its runner, :meth:`_run_batch_sharded`)."""
        key = (query.cache_key_fields(), plan, batch, shared_table, epochs)
        hit = self._batched.get(key)
        if hit is not None:
            return hit
        task, agg = self.engine._aggregate_for(query)
        compiled = program_lib.build_program(
            task, agg,
            program_lib.EpochProgram(plan=plan, batch=batch, shared_table=shared_table,
                                     epochs=epochs),
        )
        self._batched_put(key, compiled)
        return compiled

    def _run_batch(self, tickets: List[Ticket], plan: planner_lib.Plan) -> bool:
        """Stack the group along a new query axis and execute the whole
        multi-epoch run as ONE fused run. Each lane opens the draws of its
        singleton run and keeps its state after its own epoch budget, so
        a fused query returns the model ``Engine.run`` gives it (bit for
        bit for kernel lanes on the card). Returns False when the group
        fell back to singleton runs instead of fusing."""
        queries = [t.query for t in tickets]
        q0 = queries[0]
        for q in queries:
            self.engine._check_data(q)
        epochs = max(q.epochs for q in queries)
        budgets = [q.epochs for q in queries]
        ids0 = tuple(id(v) for v in q0.data.values())
        shared_table = all(tuple(id(v) for v in q.data.values()) == ids0 for q in queries[1:])
        if plan.parallelism == "sharded":
            if not shared_table:
                # per-query segment banks would multiply the partitioned
                # table's footprint; distinct tables stay singleton
                for t in tickets:
                    t.result = self.engine.run(t.query)
                    t.done_s = timing.now()
                return False
            self._run_batch_sharded(tickets, plan, epochs, budgets)
            return True
        compiled = self._batched_compile(q0, plan, len(queries), shared_table, epochs)
        lane_draws = draws_lib.lane_streams(
            self.engine.draws, [q.seed for q in queries], q0.n_examples, self.engine.device
        )
        states0 = compiled.init_fn(lane_draws)
        stacked = None
        if not shared_table:
            stacked = {k: torch.stack([q.data[k] for q in queries]) for k in q0.data}
        source = q0.data if shared_table else stacked

        def assemble():
            if compiled.prep_fn is not None:
                # ShuffleOnce's one draw a lane, then the same permuted
                # copies every epoch — one gather up front
                return compiled.prep_fn(source, lane_draws)
            return source

        def execute(examples):
            return compiled.run_fn(states0, examples, lane_draws, budgets)

        launches0 = sum(igd_kernel.launches.values())
        _, states, shuffle_s, grad_s = self._timed_phases(
            assemble, execute, lanes=len(queries), implementation=plan.implementation)
        launches = sum(igd_kernel.launches.values()) - launches0
        models = compiled.agg.terminate(states)
        losses = compiled.loss_fn(models, source)
        self._finish_group(
            tickets, models, losses, plan, shuffle_s=shuffle_s, grad_s=grad_s,
            trace_count=compiled.trace_count, kernel_launches=launches,
        )
        return True

    def _run_batch_sharded(self, tickets: List[Ticket], plan: planner_lib.Plan, epochs: int,
                           budgets: List[int]) -> None:
        """Fuse same-key queries over ONE shared table into the sharded
        subsystem: the plan's local-SGD blocks gain a query axis with
        per-lane epoch budgets (``runner.block(..., batch=B)``), for every
        ordering — B concurrent fits pay one table placement and share the
        runner's blocks. Each query draws from its own singleton run's
        stream, so its result is its ``Engine.run``'s (bit for bit for
        kernel lanes on the card: lane ``s * B + q`` of the launch is lane
        s of query q's own launch)."""
        from repro_torch.engine import shard as shard_lib

        queries = [t.query for t in tickets]
        q0 = queries[0]
        b = len(queries)
        compiled = self.engine._compile(q0, plan)
        runner = compiled.program.runner
        n = q0.n_examples
        key = ("sharded", q0.cache_key_fields(), plan, b, epochs)
        aux = self._batched.get(key)
        if aux is None:
            aux = program_lib.build_program(
                compiled.program.task, runner.agg,
                program_lib.EpochProgram(plan=plan, batch=b, shared_table=True, epochs=epochs),
            )
            self._batched_put(key, aux)
        device = self.engine.device
        shard_lib.check_plan(plan, n)
        lane_draws = draws_lib.lane_streams(self.engine.draws, [q.seed for q in queries], n, device)
        states0 = aux.init_fn(lane_draws)

        def assemble():
            return shard_lib.place_batched_inputs(runner, q0.data, n, lane_draws)

        def execute(placed):
            return shard_lib.run_batch_blocks(runner, states0, placed, n, epochs, budgets, device)

        launches0 = sum(igd_kernel.launches.values())
        _, states, shuffle_s, grad_s = self._timed_phases(
            assemble, execute, lanes=b * plan.num_shards, implementation=plan.implementation)
        launches = sum(igd_kernel.launches.values()) - launches0
        models = runner.agg.terminate(states)
        losses = aux.loss_fn(models, q0.data)
        self._finish_group(
            tickets, models, losses, plan, shuffle_s=shuffle_s, grad_s=grad_s,
            trace_count=compiled.trace_count, kernel_launches=launches,
        )

    def metrics(self) -> Dict[str, Any]:
        """The serving surface in one read: the admission/batching
        counters (including the shed and fused-lane tallies), live queue
        state, the SLO breaches and the obs registry's ``serve.*``
        aggregates — per-task queue-wait and end-to-end latency
        histograms (p50/p99) plus the fused assembly/execute walls."""
        return dict(self.stats, queue_depth=self.queue_depth,
                    batched_plans=len(self._batched),
                    slo_breaches=len(self.slo.breaches) if self.slo else 0,
                    obs=obs.metrics.snapshot("serve."))

    def cache_info(self) -> Dict[str, int]:
        return dict(self.stats, batched_plans=len(self._batched), **self.engine.cache_info())
