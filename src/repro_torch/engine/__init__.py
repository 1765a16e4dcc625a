"""repro_torch.engine — the unified in-RDBMS analytics engine (the paper's
"RDBMS layer"): task catalog, declarative queries, cost-based physical
planning, and compiled-plan-cached execution, on PyTorch.

Typical use::

    from repro_torch import engine

    res = engine.run(engine.AnalyticsQuery(task="logreg", data=table,
                                           task_args={"dim": 54}))
    print(res.describe())

``run``/``explain``/``explain_analyze``/``cache_info`` go to ``DEFAULT``, the process-wide
engine on the CUDA card, built at first use (so importing this package
on a machine without a card works; using ``DEFAULT`` there raises).
An engine on another device is ``Engine(device=...)``.
"""

from repro_torch.engine.catalog import TaskSpec, get, names, register_task, unregister  # noqa: F401
from repro_torch.engine.executor import Engine, EngineResult  # noqa: F401
from repro_torch.engine.planner import Plan, PlanReport, label_clusteredness  # noqa: F401
from repro_torch.engine.program import CompiledProgram, EpochProgram, build_program  # noqa: F401
from repro_torch.engine.query import AnalyticsQuery  # noqa: F401
from repro_torch.engine.serve import PlanStore, ServeConfig, ServingEngine, Ticket  # noqa: F401
from repro_torch.engine.table import ChunkedTable  # noqa: F401
from repro_torch.engine import probes, program, serve, shard, sweep, table  # noqa: F401

_DEFAULT = None


def default_engine() -> Engine:
    """The process-wide engine: callers share one compiled-plan cache,
    which is the point (repeat queries hit compiled plans)."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Engine()
    return _DEFAULT


def __getattr__(name):
    if name == "DEFAULT":
        return default_engine()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def run(query: AnalyticsQuery, *, plan=None) -> EngineResult:
    return default_engine().run(query, plan=plan)


def explain(query: AnalyticsQuery) -> PlanReport:
    return default_engine().explain(query)


def explain_analyze(query: AnalyticsQuery):
    """EXPLAIN ANALYZE on the default engine: run the chosen plan under
    the tracer and return the predicted-vs-measured ``obs.DriftReport``
    (see ``Engine.explain_analyze``)."""
    return default_engine().explain_analyze(query)


def cache_info() -> dict:
    return default_engine().cache_info()
