#!/usr/bin/env python3
"""Sharded local SGD over d devices: k = 4 shards placed on 1, 2 and 4
devices of one host, one process driving them all (single controller).

    python3 scripts/torch_shard_devices.py [--seed N] [--device cpu]

On CUDA cards (run it on a host with 2 or 4 of them) the table is the
Forest-shaped one (581,012 x 54 f32, generated on the first card from
--seed); with ``--device cpu`` it runs over 4 virtual CPU devices
(``launch.mesh.force_host_device_count``) on a 4,096-row table, to check
the script. For each placement d it runs logreg (cuda_fused) and
least_squares (cuda_minibatch) at k = 4, H = 1 for 3 epochs under
clustered and shuffle_always, and logreg (torch_fold, one epoch) on the
table's first 4,096 rows; then 8 logreg queries served as one fused
sharded batch at d = 2. It checks:

* a kernel epoch is one lane launch a device (k / d lanes each), and
  each device's lanes ran there (its share of the segments, moved once);
* d = 4 equals d = 1 bit for bit for the kernel lanes (each lane is its
  one-lane launch, and both placements fold the merge tree left to
  right); d = 2 folds (l0+l1)+(l2+l3) and is held to d = 1 at 1e-5/1e-7
  (the reference's placement tolerance); the eager lanes (a vmap of 4
  lanes at d = 1, one fold a device at d = 4) at the same tolerance;
* each served query equals its own sharded run bit for bit.

It prints ms an epoch for each run (host wall over the blocks, after a
wait for every device; each timed run follows an untimed one of the same
plan, so the kernels are built and the cards' clocks are up) and the
cards' names and power limits. Draws come from the engine's default
source on the first device, whatever the placement."""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

ROWS, DIM, EAGER_ROWS, EPOCHS, QUERIES = 581_012, 54, 4_096, 3, 8
RTOL, ATOL = 1e-5, 1e-7


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    from repro_torch import engine, timing
    from repro_torch.data import synthetic
    from repro_torch.engine import serve
    from repro_torch.kernels.igd_fused import kernel as K
    from repro_torch.launch import mesh

    cuda = args.device == "cuda"
    if cuda:
        if torch.cuda.device_count() < 2:
            print("torch_shard_devices: needs 2 or more CUDA cards", file=sys.stderr)
            return 2
        dev = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip(), flush=True)
        rows = ROWS
    else:
        dev = torch.device("cpu")
        mesh.force_host_device_count(4)
        rows = EAGER_ROWS
    count = mesh.shard_device_count(dev)
    placements = [d for d in (1, 2, 4) if d <= count]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    table = synthetic.dense_classification(gen, rows, DIM)
    eager = {k: v[:EAGER_ROWS].contiguous() for k, v in table.items()}
    eng = engine.Engine(device=dev)

    def sync_all():
        for d in mesh.shard_devices(count, dev):
            timing.sync(d)

    def run(task, data, ordering, impl, d, epochs=EPOCHS, seed=args.seed):
        q = engine.AnalyticsQuery(task=task, data=data, task_args={"dim": DIM}, epochs=epochs, tolerance=0.0,
                                  seed=seed)
        plan = engine.Plan(ordering, implementation=impl, parallelism="sharded", num_shards=4, merge_period=1,
                           shard_devices=d)
        K.reset_launches()
        sync_all()
        watch = timing.Stopwatch()
        res = eng.run(q, plan=plan)
        sync_all()
        wall = watch.lap()
        launched = sum(K.launches.values())
        if impl != "torch_fold" and cuda and launched != epochs * d:
            raise AssertionError(f"{task} {impl} d={d}: {launched} launches in {epochs} epochs")
        if not bool(torch.isfinite(res.model).all()):
            raise AssertionError(f"{task} {impl} d={d}: the model is not finite")
        return res, wall, launched

    failures = 0
    for task, impl, data, orderings, epochs in (
            ("logreg", "cuda_fused", table, ("clustered", "shuffle_always"), EPOCHS),
            ("least_squares", "cuda_minibatch", table, ("clustered", "shuffle_always"), EPOCHS),
            ("logreg", "torch_fold", eager, ("clustered",), 1)):
        n = next(iter(data.values())).shape[0]
        for ordering in orderings:
            base = None
            for d in placements:
                run(task, data, ordering, impl, d, epochs)  # warm-up: builds, clocks
                res, wall, launched = run(task, data, ordering, impl, d, epochs)
                line = (f"{task} {impl} {ordering} {n} x {DIM}, k = 4 over {d} device(s): "
                        f"{res.gradient_seconds / res.epochs * 1e3:.3f} ms an epoch (blocks), wall {wall:.3f} s, "
                        f"{launched} launches in {res.epochs} epochs, loss {res.losses[-1]:.6g}")
                if base is None:
                    base = res
                else:
                    err = float((res.model - base.model).abs().max())
                    exact = torch.equal(res.model, base.model)
                    ok = torch.allclose(res.model, base.model, rtol=RTOL, atol=ATOL)
                    if impl != "torch_fold" and d == 4 and not exact:
                        ok = False
                    line += f"; vs d = 1: max |dw| {err:.3g}{' (bit for bit)' if exact else ''}"
                    if not ok:
                        failures += 1
                        line += " — FAILED"
                print(line, flush=True)

    # 8 queries x 4 shards served as one fused sharded batch over 2 devices
    if 2 in placements:
        hints = {"ordering": "shuffle_always", "parallelism": "sharded", "num_shards": 4, "merge_period": 1,
                 "shard_devices": 2, "implementation": "cuda_fused"}
        queries = [engine.AnalyticsQuery(task="logreg", data=table, task_args={"dim": DIM}, tolerance=0.0,
                                          seed=s, epochs=3 if s % 2 == 0 else 2, hints=hints)
                   for s in range(QUERIES)]
        srv = serve.ServingEngine(serve.ServeConfig(max_batch=QUERIES), engine=eng)
        for q in queries:
            eng.explain(q)
        srv.submit(queries[0])  # warm-up: one query through the server
        srv.drain()
        srv.stats["batches"] = 0
        K.reset_launches()
        sync_all()
        watch = timing.Stopwatch()
        tickets = [srv.submit(q) for q in queries]
        srv.drain()
        sync_all()
        fused_s = watch.lap()
        launched = K.launches["igd_fold"]
        singles = [eng.run(q) for q in queries]
        sync_all()
        single_s = watch.lap()
        same = all(t.error is None and torch.equal(t.result.model, s.model) for t, s in zip(tickets, singles))
        if not same or srv.stats["batches"] != 1 or (cuda and launched != 3 * 2):
            failures += 1
        print(f"{QUERIES} logreg queries x 4 shards over 2 devices (cuda_fused, shuffle_always, budgets 3/2): "
              f"one fused batch, {launched} igd_fold launches (one a device an epoch), drain {fused_s:.3f} s = "
              f"{QUERIES / fused_s:.2f} queries/s; one at a time {single_s:.3f} s = {QUERIES / single_s:.2f} "
              f"queries/s; every query equal to its own run bit for bit: {same}", flush=True)
    print(f"torch_shard_devices: {count} device(s), placements {placements}, "
          f"{'all checks held' if not failures else f'{failures} check(s) FAILED'}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
