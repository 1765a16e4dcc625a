"""The serving steps on DTensors (``launch/serve.py``'s
``make_prefill_step`` / ``make_decode_step`` with params laid out by
``param_specs``, the batch by ``batch_specs`` and the cache by
``cache_specs``) on 4 gloo ranks, a (2, 2) ("data", "model") mesh, tiny
llama in float32, against the same steps unsharded in each rank: the
prefill's logits within 1e-4, and 8 greedy decode steps after a prompt
prefilled into a 512-position cache (long enough for ``cache_specs`` to
split it along its length over "model") give the same tokens, with logits
within 1e-4."""

import json

from _torch_dist import run_ranks

LOGIT_TOL = 1e-4

_BODY = r"""
import json, os
import torch
from repro_torch.configs import get_arch
from repro_torch.dist import sharding as shd
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lm

B, S, MAX_LEN, STEPS = 4, 16, 512, 8


def greedy(cfg, params, prompt, caches, put):
    # the prompt prefilled into the cache, then STEPS tokens a step at a
    # time: make_decode_step's tokens, and the logits of the same steps
    # (the builder's own path, returning the logits) on a second cache
    decode = serve.make_decode_step(cfg)
    logits_step = serve._serving(cfg, lambda p, b: lm.decode_step(p, b["tokens"], b["cache"], cfg))
    tok, cache = decode(params, put({"tokens": prompt, "cache": caches[0]}))
    logits, cache2 = logits_step(params, put({"tokens": prompt, "cache": caches[1]}))
    toks, all_logits = [shd.full(tok)], [shd.full(logits)]
    for _ in range(STEPS):
        nxt = put({"tokens": tok[:, None], "cache": cache})
        tok, cache = decode(params, nxt)
        logits, cache2 = logits_step(params, dict(nxt, cache=cache2))
        toks.append(shd.full(tok))
        all_logits.append(shd.full(logits))
    return torch.stack(toks, 1), torch.stack(all_logits, 1), cache


def worker(rank, world, io):
    cfg = get_arch("llama3.2-3b").smoke()
    gen = torch.Generator().manual_seed(0)
    params = lm.init_lm(cfg, gen, device="cpu")
    prompt = torch.randint(0, cfg.vocab, (B, S), generator=gen, dtype=torch.int32)
    prefill = serve.make_prefill_step(cfg)
    want_logits = prefill(params, {"tokens": prompt})
    caches = [lm.init_cache(cfg, B, MAX_LEN, device="cpu") for _ in range(2)]
    want_toks, want_step_logits, want_cache = greedy(cfg, params, prompt, caches, lambda b: b)

    mesh = make_host_mesh(2, 2, device="cpu")
    shd.set_activation_ctx(mesh)
    try:
        pshard = shd.shardings(shd.param_specs(params, cfg, mesh), mesh)
        p = shd.distribute(params, pshard)
        tshard = shd.shardings(shd.batch_specs(cfg, "decode", mesh, B), mesh)["tokens"]
        caches = [lm.init_cache(cfg, B, MAX_LEN, device="cpu") for _ in range(2)]
        cshard = shd.shardings(shd.cache_specs(cfg, mesh, B, caches[0]), mesh)
        caches = [{"kv": shd.distribute(c["kv"], cshard["kv"]), "index": 0} for c in caches]

        def put(batch):
            tok = batch["tokens"]
            if not shd.is_dtensor(tok):
                tok = shd.distribute({"t": tok}, {"t": tshard})["t"]
            return {"tokens": tok, "cache": batch["cache"]}

        got_logits = prefill(p, put({"tokens": prompt, "cache": None}))
        got_toks, got_step_logits, got_cache = greedy(cfg, p, prompt, caches, put)
        kv = got_cache["kv"][0]["k"]
        out = {
            "logit_err": float((shd.full(got_logits) - want_logits).abs().max()),
            "decode_logit_err": float((got_step_logits - want_step_logits).abs().max()),
            "tokens_equal": bool(torch.equal(got_toks, want_toks)),
            "dtensors": [shd.is_dtensor(got_logits), shd.is_dtensor(kv)],
            "cache_placements": [[type(x).__name__, getattr(x, "dim", None)] for x in kv.placements],
            "cache_index": got_cache["index"],
            "cache_err": float((shd.full(kv) - want_cache["kv"][0]["k"]).abs().max()),
        }
    finally:
        shd.set_activation_ctx(None)
    if rank == 0:
        with open(os.path.join(io, "out.json"), "w") as f:
            json.dump(out, f)
"""


def test_sharded_prefill_and_decode_equal_the_unsharded_steps(tmp_path):
    run_ranks(tmp_path, 4, _BODY)
    out = json.loads((tmp_path / "out.json").read_text())
    assert out["dtensors"] == [True, True], out
    assert out["logit_err"] <= LOGIT_TOL, out
    assert out["tokens_equal"], out
    assert out["decode_logit_err"] <= LOGIT_TOL, out
    assert out["cache_err"] <= LOGIT_TOL, out
    # the cache stayed split along its length over "model", its batch over "data"
    assert out["cache_placements"] == [["Shard", 0], ["Shard", 1]], out
    assert out["cache_index"] == 16 + 8
