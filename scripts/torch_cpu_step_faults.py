#!/usr/bin/env python3
"""Page faults and wall time of the port's float32 training step on the
CPU, with PyTorch's CPU allocator on 4 KB pages and with transparent huge
pages (``THP_MEM_ALLOC_ENABLE=1``: it madvises its own allocations of
2 MB or more; chip_smoke.py sets it for its card-vs-CPU checks).

    PYTHONPATH=src python3 scripts/torch_cpu_step_faults.py [--arch NAME] [--layers N] [--vocab V] [--steps K]

Each setting runs in a subprocess of its own (the variable is read at the
first allocation): one IGD-momentum ``make_train_step`` of B 1 x 256
tokens a step, K steps, printing each step's seconds, minor page faults
and system CPU seconds. The default is minitron-4b's width at 2 layers
with its vocabulary cut to 32,768, which fits a small host."""

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(args) -> None:
    import resource
    import time

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import igd
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.optim import IGD

    cfg = get_arch(args.arch).scaled(dtype="float32", n_layers=args.layers, vocab=args.vocab)
    gen = torch.Generator().manual_seed(0)
    params = lm.init_lm(cfg, gen, "cpu")
    opt = IGD(igd.diminishing(0.002, 200.0), momentum=0.9)
    state = opt.init(params)
    tokens = torch.randint(0, cfg.vocab, (1, 256), generator=gen)
    step = train.make_train_step(cfg, opt)
    for t in range(args.steps):
        before, start = resource.getrusage(resource.RUSAGE_SELF), time.perf_counter()
        params, state, _ = step(params, state, {"tokens": tokens}, t)
        wall, after = time.perf_counter() - start, resource.getrusage(resource.RUSAGE_SELF)
        print(f"  step {t}: {wall:.3f} s, {after.ru_minflt - before.ru_minflt} minor page faults, "
              f"{after.ru_stime - before.ru_stime:.2f} s system CPU", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="minitron-4b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=32_768)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args)
        return 0
    for thp in ("0", "1"):
        print(f"{args.arch}, {args.layers} layers, vocab {args.vocab}, float32, B 1 x 256, "
              f"THP_MEM_ALLOC_ENABLE={thp}:", flush=True)
        env = dict(os.environ, THP_MEM_ALLOC_ENABLE=thp, PYTHONPATH=os.path.join(ROOT, "src"))
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child", *sys.argv[1:]], env=env, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
