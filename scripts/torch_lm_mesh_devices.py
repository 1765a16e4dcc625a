#!/usr/bin/env python3
"""The LM across a mesh of cards, one process a card (correctness only).

    torchrun --standalone --nproc-per-node 2 scripts/torch_lm_mesh_devices.py
    torchrun --standalone --nproc-per-node 4 scripts/torch_lm_mesh_devices.py
    torchrun --standalone --nproc-per-node 4 scripts/torch_lm_mesh_devices.py --device cpu

Each launch runs every ("data", "model") mesh of ``--meshes`` (default
2x1, 1x2, 2x2) whose size is the world size: 2 ranks run (2, 1) and
(1, 2), 4 ranks run (2, 2). On each mesh:

* one ``make_train_step(param_shardings=...)`` step (IGD with momentum,
  grad_accum 2) of llama3.2-3b at full width, 2 layers, float32, B 8 x S
  512, held to the unsharded step that every rank also runs on its own
  card from the same params (each leaf within 1e-4 of its largest
  element, ``chip_smoke.py`` 10b's bound); the attention kernels must have
  launched in the sharded step;
* the length-sharded decode over the process group (each rank of the
  "model" axis one ``flash_decode`` launch on its slice, then the
  all-reduce combine) at llama3.2-3b's heads, B 8, a 32,768-position bf16
  cache, lengths 1, 1,000, 8,192, 20,000 and 32,768, held to the
  unsharded kernel (2e-2).

It prints each rank's card and power limit and, on rank 0, the step's ms
sharded and unsharded (CUDA events; not a benchmark). ``--device cpu``
checks the script over gloo with llama3.2-3b's smoke config and a
1,024-position cache. Exits non-zero on any disagreement."""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

LENGTHS, DECODE_B, DECODE_S = (1, 1000, 8192, 20000, 32768), 8, 32768
TRAIN_B, TRAIN_S, LAYERS, TOL = 8, 512, 2, 1e-4


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--meshes", nargs="+", default=["2x1", "1x2", "2x2"])
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.core import igd
    from repro_torch.core.tree import leaves, tree_map
    from repro_torch.dist import collectives, sharding as shd
    from repro_torch.kernels.attention import kernel as AK
    from repro_torch.kernels.decode import kernel as DK
    from repro_torch.launch import mesh as mesh_mod, train
    from repro_torch.models import lm
    from repro_torch.optim import IGD

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("torch_lm_mesh_devices: no CUDA card", file=sys.stderr)
        return 2
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if cuda:
        torch.cuda.set_device(local)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", local) if cuda else torch.device("cpu")
    dist.init_process_group("nccl" if cuda else "gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    card = "cpu"
    if cuda:
        card = subprocess.run(["nvidia-smi", f"--id={torch.cuda.current_device()}",
                               "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip()
    print(f"[rank {rank}/{world}] {dev}: {card}", flush=True)
    if cuda:
        for lib in (AK.LIBRARY, AK.BWD_LIBRARY, DK.LIBRARY):
            if rank == 0:
                lib.load()
            dist.barrier()
            lib.load()
    cfg = get_arch("llama3.2-3b")
    decode_s = DECODE_S if cuda else 1024
    small = (cfg if cuda else cfg.smoke()).scaled(n_layers=LAYERS, dtype="float32")
    failures = 0
    try:
        for name in args.meshes:
            data, model = (int(x) for x in name.split("x"))
            if data * model != world:
                continue
            mesh = mesh_mod.make_host_mesh(data, model, device=dev)
            gen = torch.Generator(device=dev)
            gen.manual_seed(args.seed)
            # -- the sharded train step against the unsharded one on this card
            params = lm.init_lm(small, gen, dev)
            tokens = torch.randint(0, small.vocab, (TRAIN_B, TRAIN_S if cuda else 32), generator=gen, device=dev)
            opt = IGD(igd.diminishing(0.002, 200.0), momentum=0.9)
            plain_p = tree_map(lambda x: x.clone(), params)
            plain_o = opt.init(plain_p)
            shd.set_activation_ctx(mesh)
            pshard = shd.shardings(shd.param_specs(params, small, mesh), mesh)
            sp = shd.distribute(params, pshard)
            so = tuple(shd.distribute(t, pshard) for t in opt.init(params))
            batch = shd.distribute({"tokens": tokens},
                                   shd.shardings(shd.batch_specs(small, "train", mesh, TRAIN_B), mesh))
            AK.reset_launches()
            ms = {}
            for what, fn in (("sharded", lambda: train.make_train_step(
                    small, opt, grad_accum=2, param_shardings=pshard)(sp, so, batch, 0)),
                             ("unsharded", lambda: train.make_train_step(small, opt, grad_accum=2)(
                                 plain_p, plain_o, {"tokens": tokens}, 0))):
                if cuda:
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                out = fn()
                if cuda:
                    end.record()
                    end.synchronize()
                    ms[what] = start.elapsed_time(end)
                if what == "sharded":
                    sp, so, sm = out
                    launched = dict(AK.launches)
                else:
                    plain_p, plain_o, pm = out
            shd.set_activation_ctx(None)
            worst = 0.0
            for got, want in zip(leaves(shd.full(sp)) + leaves(shd.full(so)), leaves(plain_p) + leaves(plain_o)):
                worst = max(worst, float((got.detach() - want.detach()).abs().max())
                            / max(float(want.detach().abs().max()), 1e-30))
            loss_gap = abs(float(sm["loss"]) - float(pm["loss"]))
            ok = worst <= TOL and loss_gap <= TOL * abs(float(pm["loss"])) and (not cuda or all(launched.values()))
            failures += not ok
            print(f"[rank {rank}] mesh ({data}, {model}) train step: loss {float(sm['loss']):.7f} sharded, "
                  f"{float(pm['loss']):.7f} unsharded; max |sharded - unsharded| / max |unsharded| {worst:.3g} "
                  f"(tol {TOL:g}); attention launches in the sharded step {launched}; ms {ms or 'not measured'}; "
                  f"{'ok' if ok else 'FAILED'}", flush=True)
            del params, plain_p, plain_o, sp, so, batch
            # -- the length-sharded decode over the group
            h, kv, hd = small.n_heads, small.n_kv_heads, small.hd
            dgen = torch.Generator(device=dev)
            dgen.manual_seed(args.seed + 1)  # the same cache on every rank
            q = torch.randn((DECODE_B, h, hd), generator=dgen, device=dev).to(torch.bfloat16)
            kc = torch.randn((DECODE_B, decode_s, kv, hd), generator=dgen, device=dev).to(torch.bfloat16)
            vc = torch.randn((DECODE_B, decode_s, kv, hd), generator=dgen, device=dev).to(torch.bfloat16)
            lengths = [n for n in LENGTHS if n <= decode_s]
            DK.reset_launches()
            gots = [collectives.sharded_flash_decode(q, kc, vc, length, mesh) for length in lengths]
            sharded_launches = DK.launches["flash_decode"]
            errs = []
            for length, got in zip(lengths, gots):
                want = DK.flash_decode(q, kc, vc, length)[0] if cuda else \
                    collectives.decode_ref.decode_attention_ref(q, kc, vc, length)[0]
                errs.append(float((got.float() - want.float()).abs().max()))
            ok = max(errs) <= 2e-2 and (not cuda or sharded_launches == len(lengths))
            failures += not ok
            print(f"[rank {rank}] mesh ({data}, {model}) sharded decode over {model} length shard(s): max |err| vs "
                  f"the unsharded kernel {max(errs):.3g} (tol 2e-2); flash_decode launches "
                  f"{sharded_launches} for {len(lengths)} calls on this rank; {'ok' if ok else 'FAILED'}", flush=True)
            del q, kc, vc
            if cuda:
                torch.cuda.empty_cache()
        failed = torch.tensor([failures], device=dev)
        dist.all_reduce(failed)
        if rank == 0:
            print(f"torch_lm_mesh_devices: world {world}, {int(failed)} failure(s)", flush=True)
        return 1 if int(failed) else 0
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
