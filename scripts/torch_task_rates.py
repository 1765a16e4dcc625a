#!/usr/bin/env python3
"""Per-row rates of the port's six other techniques on one CUDA card.

    python3 scripts/torch_task_rates.py [--rows 256] [--seed 0]

For each of sparse_logreg, sparse_svm, lmf, crf, kalman and portfolio,
on a table made on the card at the widths ``chip_smoke.py`` phase 3c
uses: the eager fold's and the segmented fold's (k = 8) µs a row over
``--rows`` rows, the shared-memory simulator's (lmf, portfolio), whether
one pass of each syncs with the host (``set_sync_debug_mode("error")``),
and the wall of a first ``Engine.explain`` on a 2,048-row slab (the
planner's probes). Then the Fig. 7 baselines at full size. Exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_task_rates: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    from repro_torch import engine, timing
    from repro_torch.core import draws, mrs, parallel, tree, uda
    from repro_torch.data import synthetic
    from repro_torch.tasks import baselines

    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rows = args.rows
    cost = tuple(torch.linspace(-0.1, 0.1, 500).tolist())
    tables = {
        "sparse_logreg": (synthetic.sparse_classification(gen, 16_384, 41_000, 16), {"dim": 41_000}),
        "sparse_svm": (synthetic.sparse_classification(gen, 16_384, 41_000, 16), {"dim": 41_000}),
        "lmf": (synthetic.ratings(gen, 6_040, 3_952, 1_000_209), {"n_rows": 6_040, "n_cols": 3_952, "rank": 8}),
        "crf": (synthetic.tagged_sequences(gen, 1_024, 32, 23, 64), {"n_labels": 23, "feat_dim": 64}),
        "kalman": (synthetic.kalman_series(gen, 2_048, 16, 8), {"horizon": 2_048, "state_dim": 16, "obs_dim": 8}),
        "portfolio": (synthetic.returns(gen, 2_520, 500), {"n_assets": 500, "expected_returns": cost}),
    }
    print(f"{torch.cuda.get_device_name(0)}; rows {rows}", flush=True)

    def per_row(fn, n):
        return timing.seconds(fn, dev) / n * 1e6

    def syncs(fn) -> str:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
            return "no host sync"
        except RuntimeError as e:
            return f"HOST SYNC: {str(e).splitlines()[0][:160]}"
        finally:
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()

    for name, (data, task_args) in tables.items():
        small = {k: v[:rows].contiguous() for k, v in data.items()}
        eng = engine.Engine()
        task, agg = eng._aggregate_for(engine.AnalyticsQuery(task=name, data=small, task_args=task_args))
        state = uda.initial_state(draws.TorchDraws().stream(args.seed, rows, dev).initial_model(task))
        uda.fold(agg, state, {k: v[:8] for k, v in small.items()})  # warm-up
        line = (f"{name}: eager fold {per_row(lambda: uda.fold(agg, state, small), rows):.1f} us a row "
                f"({syncs(lambda: uda.fold(agg, state, small))}), segmented k=8 "
                f"{per_row(lambda: uda.segmented_fold(agg, state, small, 8), rows):.1f} "
                f"({syncs(lambda: uda.segmented_fold(agg, state, small, 8))})")
        if name in ("lmf", "portfolio"):
            ep = draws.TorchDraws().stream(args.seed, rows, dev).epoch()
            for sm in ("lock", "aig", "nolock"):
                cfg = parallel.SharedMemoryConfig(sm, 8)
                v, k = parallel.hogwild_draws(ep, cfg, tree.size(state.model))

                def fold(cfg=cfg, v=v, k=k):
                    return parallel.hogwild_fold(task, agg.step_size, state.model, small, cfg, v, k, agg.prox)

                line += f", {sm} {per_row(fold, rows):.1f} ({syncs(fold)})"
            buf = mrs.zero_buffer(8, small)
            line += ", mrs epoch " + syncs(lambda: mrs.mrs_epoch(agg, state, small, buf, buf, True,
                                                                 mrs.MRSConfig(8, 2), ep.reservoir()))
        print(line, flush=True)
        watch = timing.Stopwatch()
        slab = {k: v[:2_048] for k, v in data.items()}
        rep = eng.explain(engine.AnalyticsQuery(task=name, data=slab, task_args=task_args, epochs=2))
        print(f"  first explain on {next(iter(slab.values())).shape[0]} rows: {watch.lap():.2f} s "
              f"(probes); chose {rep.chosen.describe()}", flush=True)

    forest = synthetic.dense_classification(gen, 581_012, 54)
    out = {}
    ms = timing.seconds(lambda: out.update(w=baselines.irls_logistic(forest, steps=25, ridge=1e-3)), dev) * 1e3
    print(f"irls_logistic 581012x54, 25 steps: {ms:.2f} ms, loss "
          f"{float(engine.get('logreg').make_task(dim=54).full_loss(out['w'], forest)):.6g}")
    ratings, lmf_args = tables["lmf"]
    ms = timing.seconds(lambda: out.update(m=baselines.als_lmf(ratings, 6_040, 3_952, 8, sweeps=8, generator=gen)),
                        dev) * 1e3
    print(f"als_lmf 1,000,209 ratings, 8 sweeps: {ms:.2f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
