"""repro_torch.engine.shard — the sharded-parallelism driver.

The construction of the merge-period-H local-SGD blocks (and the
step-size compensation that keeps k = 1 bit-identical to ``Engine.run``)
lives in ``repro_torch.engine.program``, the one compiler every
execution path shares; this module re-exports those pieces and keeps
what is a driver's job:

* ``place_inputs`` / ``place_batched_inputs`` — lay the epoch stream out
  over the plan's devices for each ordering (contiguous segments split
  into each device's lanes; permutation slices over a replicated table;
  the run's draws for the in-run reshuffle), drawing from the engine's
  one ``core.draws`` source in the singleton executor's order, so k = 1
  (and every fused lane) stays bit-identical;
* ``execute`` — the block loop: blocks of H epochs, the merged model at
  every block boundary (where losses and stop rules are evaluated), the
  final merged model out. It mirrors ``executor._execute``'s result
  contract: ``shuffle_seconds`` is the placement, ``gradient_seconds``
  the blocks, both host wall time through ``repro_torch.timing``.

Paper context (§3.3, Fig. 9): partition the table, train partial models,
``merge`` by weighted model averaging — here the k partitions are the
lanes of one kernel launch (or of one ``vmap``) on each device.

Instrumented as the reference is: the ``shard.place`` span and
``shard.place_s`` around the placement, a ``shard.block`` span
(attributes ``epochs`` and ``k``) and ``shard.block_s`` around each block,
each closed after the sync the driver already makes, and the
``shard.merge_staleness_epochs`` gauge. A block's kernel lanes open no
``engine.kernel`` span (the reference opens it only on the singleton
path): the k shards are the lanes of one launch an epoch a device, so
``shard.block`` carries ``implementation`` as a further attribute and
``k`` is the lane count.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import torch

from repro_torch import obs, timing
from repro_torch.core import convergence, uda as uda_lib
from repro_torch.core.tree import leaves
from repro_torch.dist import data_parallel as dp
from repro_torch.engine.program import (  # noqa: F401  (re-exported driver API)
    SHARD_MODES as _MODES,
    ShardedRunner,
    compensated_aggregate,
    compensated_step_size,
)
from repro_torch.kernels.igd_fused import kernel as igd_kernel


def _ids(data) -> Tuple:
    return tuple(id(x) for x in leaves(data))


def _segments(runner: ShardedRunner, data, ids: Tuple):
    k = runner.plan.num_shards
    return runner.placed(("seg", ids), tuple(leaves(data)),
                         lambda: dp.scatter_lanes(dp.partition_rows(data, k), runner.devices))


def _replicated(runner: ShardedRunner, data, ids: Tuple):
    return runner.placed(("rep", ids), tuple(leaves(data)),
                         lambda: dp.replicate(data, runner.devices))


def place_inputs(runner: ShardedRunner, data, n: int, draws) -> Tuple[str, tuple]:
    """Lay the epoch stream out over the runner's devices, drawing what
    the singleton executor draws, in its order, so k = 1 stays
    bit-identical:

    * clustered      — contiguous segments, each device's lanes on it;
      no draw;
    * shuffle_once   — ONE permutation (ShuffleOnce's); the eager lanes
      get per-lane index slices over a replicated table (the gather rides
      in the fold), the kernel lanes their rows gathered once, as
      segments;
    * shuffle_always — the table replicated; each in-block epoch draws
      the permutation and then opens the epoch (``draws`` travels with
      the arguments).

    Returns ``(mode, args)``: ``runner.block(mode, ...)(state, *args)``."""
    k = runner.plan.num_shards
    mode = _MODES[runner.plan.ordering]
    ids = _ids(data)
    if mode == "segments":
        return mode, (_segments(runner, data, ids),)
    if mode == "perm_once":
        perm = draws.permutation()
        if runner.kernel:
            rows = {c: v[perm] for c, v in data.items()}
            return "segments", (dp.scatter_lanes(dp.partition_rows(rows, k), runner.devices),)
        perms = dp.scatter_lanes(perm.reshape(k, n // k), runner.devices)
        return mode, (_replicated(runner, data, ids), perms)
    return mode, (_replicated(runner, data, ids), draws)


def place_batched_inputs(runner: ShardedRunner, data, n: int, lane_draws) -> Tuple[str, tuple]:
    """The fused-serving layout: B query lanes over ONE shared table, each
    drawing from its own singleton run's stream (``lane_draws``, one
    ``RunDraws`` a query) exactly as that run would:

    * clustered      — the shared partitioned segments (the B queries'
      lanes read each segment: ``kernel.lanes_per_xy``); no draw;
    * shuffle_once   — one permutation a query; the eager lanes get
      slices ``[lanes, B, n/k]`` over the replicated table, the kernel
      lanes the B permuted copies gathered once, shard-major
      ``[lanes, B, n/k, ...]``;
    * shuffle_always — the table replicated, the B streams carried into
      the blocks (each in-block epoch draws every query's permutation,
      then opens its epoch).

    Returns ``(mode, args)`` as :func:`place_inputs` does."""
    k = runner.plan.num_shards
    b = len(lane_draws)
    mode = _MODES[runner.plan.ordering]
    ids = _ids(data)
    if mode == "segments":
        return mode, (_segments(runner, data, ids),)
    if mode == "perm_once":
        # [B, n] -> [k, B, n/k]: shard-major, so the slices split by lane
        perms = torch.stack([ld.permutation() for ld in lane_draws])
        perms = perms.reshape(b, k, n // k).transpose(0, 1)
        if runner.kernel:
            rows = {c: v[perms] for c, v in data.items()}
            return "segments", (dp.scatter_lanes(rows, runner.devices),)
        return mode, (_replicated(runner, data, ids), dp.scatter_lanes(perms, runner.devices))
    return mode, (_replicated(runner, data, ids), list(lane_draws))


def check_plan(plan, n: int) -> None:
    """The block loop's preconditions (a forced plan bypasses the
    planner's checks)."""
    if plan.num_shards < 1 or plan.merge_period < 1:
        raise ValueError(
            f"sharded plan needs num_shards >= 1 and merge_period >= 1, "
            f"got k={plan.num_shards}, H={plan.merge_period}"
        )
    if n % plan.num_shards:
        raise ValueError(f"{n} rows not divisible into {plan.num_shards} shards")


def execute(compiled, query, report, engine) -> Any:
    """Run a sharded plan: blocks of H epochs, the merged model at every
    block boundary (where losses and stop rules are evaluated), the final
    merged model out. Mirrors ``executor._execute``'s result contract."""
    from repro_torch.engine import executor as executor_lib

    program = compiled.program
    plan = program.plan
    runner: ShardedRunner = program.runner
    agg = runner.agg
    device = engine.device
    n = query.n_examples
    check_plan(plan, n)
    # sharded layouts need random access: a stored table materializes
    # through the one resolve seam, onto the engine's device
    data = executor_lib.materialize(query.data, device, engine.stats)
    draws = engine.draws.stream(query.seed, n, device)

    if query.target_loss is not None:
        stop = lambda losses, epoch: bool(  # noqa: E731
            losses and losses[-1] <= query.target_loss
        )
    elif query.tolerance:
        stop = convergence.RelativeLossDrop(query.tolerance)
    else:
        stop = None

    def eval_loss(state) -> float:
        return float(compiled.loss_fn(agg.terminate(state), data))

    state = uda_lib.initial_state(draws.initial_model(agg.task))
    launches0 = sum(igd_kernel.launches.values())

    watch = timing.Stopwatch()
    with obs.span("shard.place", ordering=plan.ordering, k=plan.num_shards):
        mode, args = place_inputs(runner, data, n, draws)
        timing.sync(device)
    shuffle_s = watch.lap()
    obs.metrics.observe("shard.place_s", shuffle_s)

    losses: List[float] = []
    grad_s = 0.0
    converged = False
    done = 0
    while done < query.epochs:
        block_len = min(plan.merge_period, query.epochs - done)
        fn = runner.block(mode, block_len, n)
        watch.lap()
        with obs.span("shard.block", epochs=block_len, k=plan.num_shards,
                      implementation=plan.implementation):
            state = fn(state, *args)
            timing.sync(device)
        block_s = watch.lap()
        obs.metrics.observe("shard.block_s", block_s)
        # merge staleness: local models drift for block_len epochs
        # between model-averaging merges (the H in local SGD)
        obs.metrics.set_gauge("shard.merge_staleness_epochs", block_len)
        grad_s += block_s
        done += block_len
        # the merged (global) model exists exactly at block boundaries —
        # the natural granularity for the objective and stop rules
        if stop is not None:
            losses.append(eval_loss(state))
            if stop(losses, done):
                converged = True
                break
    if stop is None and done:
        losses.append(eval_loss(state))

    return executor_lib.EngineResult(
        model=agg.terminate(state),
        losses=losses,
        epochs=done,
        converged=converged,
        plan=plan,
        report=report,
        shuffle_seconds=shuffle_s,
        gradient_seconds=grad_s,
        trace_count=compiled.trace_count,
        loss_trace_count=compiled.loss_trace_count,
        kernel_launches=sum(igd_kernel.launches.values()) - launches0,
    )


def run_batch_blocks(runner: ShardedRunner, states, placed: Tuple[str, tuple], n: int,
                     epochs: int, budgets: List[int], device):
    """The fused sharded batch's blocks (``ServingEngine``'s sharded
    groups, after :func:`place_batched_inputs` gave ``placed``): blocks
    of H epochs over the B queries' stacked ``states`` with their epoch
    budgets. Returns the states (the caller syncs)."""
    plan = runner.plan
    mode, args = placed
    b = len(budgets)
    budgets_dev = torch.tensor(list(budgets), dtype=torch.int64, device=device)
    done = 0
    while done < epochs:
        block_len = min(plan.merge_period, epochs - done)
        states = runner.block(mode, block_len, n, batch=b)(states, *args, budgets_dev, done)
        done += block_len
    return states
