"""repro_torch.engine.serve — the analytics serving front end.

A database serves many concurrent analytics queries, not one script at a
time. This layer models that multi-tenant reality on top of the engine
with three mechanisms:

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

The reference's operational telemetry (its obs spans and metrics, the
gauges, the flight recorder, SLO monitoring and the EXPLAIN ANALYZE
drift reports the store keeps beside each plan) comes with the port's
obs slice (ROADMAP queue 1 item 6).

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

from repro_torch import timing
from repro_torch.core import draws as draws_lib
from repro_torch.core.tree import tree_map
from repro_torch.engine import executor, planner as planner_lib
from repro_torch.engine import program as program_lib
from repro_torch.engine.query import AnalyticsQuery
from repro_torch.kernels.igd_fused import kernel as igd_kernel

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
        """Live plan-entry count (tmp files excluded)."""
        try:
            names = os.listdir(self.root)
        except OSError:
            return 0
        return sum(1 for n in names if n.startswith("plan_") and n.endswith(".json"))

    def _path(self, plan_key: Tuple) -> str:
        digest = hashlib.sha256(repr(plan_key).encode()).hexdigest()[:32]
        return os.path.join(self.root, f"plan_{digest}.json")

    def load(self, plan_key: Tuple, query: AnalyticsQuery) -> Optional[planner_lib.PlanReport]:
        try:
            with open(self._path(plan_key)) as f:
                entry = json.load(f)
        except (OSError, ValueError):
            return None
        if (
            entry.get("version") != FORMAT_VERSION
            or entry.get("key") != repr(plan_key)
            or entry.get("fingerprint") != query.content_fingerprint()
        ):
            return None
        try:
            return planner_lib.PlanReport.from_dict(entry["report"])
        except (KeyError, TypeError, ValueError):
            return None

    def store(self, plan_key: Tuple, query: AnalyticsQuery,
              report: planner_lib.PlanReport) -> None:
        self._write(self._path(plan_key), plan_key, query, {"report": report.to_dict()})

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
            return Ticket(query, False, REJECT_QUEUE_FULL, submit_s=now)
        if self._queued_per_task[query.task] >= self.config.max_per_task:
            self.stats["rejected"] += 1
            self.stats["shed_task_limit"] += 1
            return Ticket(query, False, REJECT_TASK_LIMIT, submit_s=now)
        ticket = Ticket(query, True, submit_s=now)
        self._queue.append(ticket)
        self._queued_per_task[query.task] += 1
        self.stats["accepted"] += 1
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

        # one bad query must not take the server loop (or the rest of the
        # queue) down with it: failures complete the ticket with an error
        try:
            if len(group) == 1:
                head.result = self.engine.run(head.query)
                head.done_s = timing.now()
                self.stats["singleton_queries"] += 1
            elif self._run_batch(group, key[1]):
                self.stats["batches"] += 1
                self.stats["batched_queries"] += len(group)
                self.stats["fused_lanes"] += len(group)
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

    def _timed_phases(self, assemble, execute) -> Tuple[Any, Any, float, float]:
        """One timing discipline for the fused path: run ``assemble``
        (input staging — stacking, the one up-front permutation) then
        ``execute`` (the fused epochs), each timed on the host clock
        after a wait for the device (``timing.Stopwatch`` +
        ``timing.sync``). Returns ``(assembled, executed, assemble_s,
        execute_s)``."""
        device = self.engine.device
        watch = timing.Stopwatch()
        assembled = assemble()
        timing.sync(device)
        assemble_s = watch.lap()
        executed = execute(assembled)
        timing.sync(device)
        return assembled, executed, assemble_s, watch.lap()

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
        _, states, shuffle_s, grad_s = self._timed_phases(assemble, execute)
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
        lane_draws = draws_lib.lane_streams(self.engine.draws, [q.seed for q in queries], n, device)
        launches0 = sum(igd_kernel.launches.values())
        states, shuffle_s, grad_s = shard_lib.run_batch(
            runner, aux, q0.data, n, lane_draws, epochs, budgets, device)
        launches = sum(igd_kernel.launches.values()) - launches0
        models = runner.agg.terminate(states)
        losses = aux.loss_fn(models, q0.data)
        self._finish_group(
            tickets, models, losses, plan, shuffle_s=shuffle_s, grad_s=grad_s,
            trace_count=compiled.trace_count, kernel_launches=launches,
        )

    def metrics(self) -> Dict[str, Any]:
        """The serving surface in one read: the admission/batching
        counters (including the shed and fused-lane tallies) and live
        queue state."""
        return dict(self.stats, queue_depth=self.queue_depth,
                    batched_plans=len(self._batched))

    def cache_info(self) -> Dict[str, int]:
        return dict(self.stats, batched_plans=len(self._batched), **self.engine.cache_info())
