#!/usr/bin/env python3
"""The dry run's predictions for chip_smoke.py's phase 10e: each family's
training cell, as 10e runs it (FAMILY_TRAIN's depth and dtype cuts and
optimizer, one sequence of train_4k's 4,096 positions), through
``repro_torch.launch.dryrun.run_cell`` at a (1, 1) fake mesh. Its
argument bytes plus its temp bytes predict the step's peak on the card
(temp counts the plain attention's [S, S] logits, yet the card's peak
ran above the prediction for half the families: PERF.md §5). No
card: fake tensors on the host.

    PYTHONPATH=src python3 scripts/torch_family_train_cells.py [NAME ...]

prints one ``RECORD {json}`` line a family as it finishes (all of
FAMILY_TRAIN by default). chip_smoke.py starts it in a subprocess with
the families it predicts.

    PYTHONPATH=src python3 scripts/torch_family_train_cells.py --small-mesh 2x2x2 NAME ...

runs instead each family's ``.smoke()`` config's ``train_4k`` cell on the
small fake meshes ``tests/test_torch_dryrun.py`` patches in (4x2 or
2x2x2, the shape cut to 256 x 8, grad_accum 2): a 3-D mesh traces too
slowly for the tests (the xLSTM's took ~30 min on a CPU)."""

import argparse
import json
import os
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    import chip_smoke  # FAMILY_TRAIN and TRAIN_IGD_STEP

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", default=sorted(chip_smoke.FAMILY_TRAIN))
    ap.add_argument("--small-mesh", choices=("4x2", "2x2x2"))
    args = ap.parse_args()
    warnings.simplefilter("ignore")
    from repro_torch.core import igd
    from repro_torch.kernels.attention import kernel as AK
    from repro_torch.launch import dryrun
    from repro_torch.optim import IGD

    if args.small_mesh:
        return small_mesh_cells(args.names, args.small_mesh == "2x2x2")
    for name in args.names:
        cut, momentum, _ = chip_smoke.FAMILY_TRAIN[name]
        start = time.time()
        rec = dryrun.run_cell(name, "train_4k", False, grad_accum=1,
                              optimizer=IGD(igd.diminishing(*chip_smoke.TRAIN_IGD_STEP), momentum=momentum),
                              cfg_overrides=cut, shape_overrides={"global_batch": 1},
                              mesh_shape={"data": 1, "model": 1})
        rec["wall_s"] = round(time.time() - start, 1)
        rec["kernel_launches"] = dict(AK.launches)
        print("RECORD " + json.dumps(rec), flush=True)
    return 0


def small_mesh_cells(names, multi_pod: bool) -> int:
    import dataclasses

    import repro_torch.configs.base as base
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh

    dryrun.make_production_mesh = lambda *, multi_pod=False: AbstractMesh(
        {"pod": 2, "data": 2, "model": 2} if multi_pod else {"data": 4, "model": 2})
    base.SHAPES["train_4k"] = dataclasses.replace(base.SHAPES["train_4k"], seq_len=256, global_batch=8)
    for name in names:
        base._REGISTRY[name + "-smoke"] = get_arch(name).smoke().scaled(name=name + "-smoke")
        start = time.time()
        rec = dryrun.run_cell(name + "-smoke", "train_4k", multi_pod, grad_accum=2)
        rec["wall_s"] = round(time.time() - start, 1)
        print("RECORD " + json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
