"""Serving entry points (``repro.launch.serve``).

Two serving surfaces share this module:

* **Analytics serving**: the engine's serving front end
  (``repro_torch.engine.serve``) — ``make_analytics_server`` builds a
  ``ServingEngine`` (admission control + cross-query batching + optional
  persistent plan cache) and ``serve_analytics`` runs a submit-and-drain
  load, returning the tickets.
* **LM serving**: batched prefill and KV-cache decode step builders with
  the reference's batch dicts, for every family of ``models.lm`` (a
  vlm/audio batch's ``prefix_embeds`` go through both builders: the
  decode builder prefills them into the cache with the prompt). Each
  builder makes the compute-dtype copy of the params once
  (``lm.cast_params``) and reuses it while it is called with the same
  params object: the reference casts float32 params at every use, which
  on the card would read 12.85 GB and write 6.4 GB per llama3.2-3b
  decode step.

Sharded (the params DTensors laid out by ``dist.sharding.param_specs``,
the batch by ``batch_specs`` and a decode cache by ``cache_specs``): the
steps run as a sharded train step's forward does. Under
``implicit_replication`` (the tensors the model makes on the spot count as
replicated), each parameter's shards over the data axes are gathered for
use (``sharding.gather_data_axes``) at every call, attention runs on each
rank's local heads (``sharding.head_local``), and the cache is written
shard by shard (``sharding.write_positions``). They return DTensors: the
logits, or the token and the cache, whose leaves keep their placements.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional

import torch

from repro_torch import obs
from repro_torch.core.tree import tree_map
from repro_torch.dist import sharding as shd
from repro_torch.engine import executor, serve as serve_lib
from repro_torch.models import lm


def make_analytics_server(
    *,
    cache_dir: Optional[str] = None,
    max_queue: int = 64,
    max_per_task: int = 32,
    max_batch: int = 8,
    slo_rules=None,
    incident_dir: Optional[str] = None,
    device=None,
) -> serve_lib.ServingEngine:
    """An analytics ``ServingEngine`` with the given admission knobs, over
    an engine on ``device`` (None: the CUDA card). ``slo_rules`` (a tuple
    of ``repro_torch.obs.SLORule``, e.g. ``obs.slo.default_serve_rules()``)
    arms breach monitoring; incidents land in ``incident_dir`` (default:
    ``<cache_dir>/incidents``)."""
    config = serve_lib.ServeConfig(
        max_queue=max_queue, max_per_task=max_per_task, max_batch=max_batch,
        cache_dir=cache_dir, slo_rules=slo_rules, incident_dir=incident_dir,
    )
    return serve_lib.ServingEngine(config, engine=executor.Engine(device=device))


def serve_analytics(
    queries: Iterable,
    *,
    server: Optional[serve_lib.ServingEngine] = None,
    trace_dir: Optional[str] = None,
    obs_port: Optional[int] = None,
    **server_kw,
) -> List[serve_lib.Ticket]:
    """Submit ``queries`` (admission-controlled), drain the queue, and
    return one ticket per query — rejected ones carry ``reject_reason``
    instead of a result. With ``trace_dir``, the whole load runs under
    the span tracer and ``serve.jsonl`` / ``serve.trace.json`` (Chrome
    trace) are written there after the drain. With ``obs_port`` (0 for
    an ephemeral port), the process obs server is started first, so
    ``/metrics``, ``/snapshot`` and ``/healthz`` are scrapeable while the
    load runs — and stay up afterwards
    (``repro_torch.launch.obs_server.stop()`` tears it down)."""
    if obs_port is not None:
        from repro_torch.launch import obs_server

        obs_server.start(obs_port)
    srv = server if server is not None else make_analytics_server(**server_kw)
    if trace_dir is None:
        tickets = [srv.submit(q) for q in queries]
        srv.drain()
        return tickets
    os.makedirs(trace_dir, exist_ok=True)
    with obs.tracing() as rec:
        tickets = [srv.submit(q) for q in queries]
        srv.drain()
    rec.export_jsonl(os.path.join(trace_dir, "serve.jsonl"))
    rec.export_chrome_trace(os.path.join(trace_dir, "serve.trace.json"))
    return tickets


def _cast_once(cfg):
    held = {}

    def cast(params):
        if held.get("source") is not params:
            held.clear()  # drop the old copy before making the new one
            held["cast"], held["source"] = lm.cast_params(params, cfg), params
        return held["cast"]

    return cast


def _serving(cfg, body):
    """``body(params, batch)`` on the compute-dtype copy of the params;
    on DTensor params under ``implicit_replication`` with each parameter's
    data-axis shards gathered for the call (see the module's docstring)."""
    cast = _cast_once(cfg)

    def step(params, batch):
        p = cast(params)
        if not shd.is_dtensor(p["embed"]):
            return body(p, batch)
        from torch.distributed.tensor.experimental import implicit_replication

        with implicit_replication():
            return body(tree_map(shd.gather_data_axes, p), batch)

    return step


def make_prefill_step(cfg):
    def prefill_step(params, batch):
        """batch: {"tokens": [B, S]} (+ "prefix_embeds" [B, P, D]) ->
        last-position logits [B, vocab]."""
        return lm.prefill(params, batch["tokens"], cfg, prefix_embeds=batch.get("prefix_embeds"))

    return _serving(cfg, prefill_step)


def make_decode_step(cfg):
    def decode_step(params, batch):
        """batch: {"tokens": [B, S], "cache": ...} (+ "prefix_embeds"
        [B, P, D]) -> (greedy next token [B] int32, cache). With S > 1 this
        prefills the chunk into the cache at its index, the prefix first."""
        logits, cache = lm.decode_step(params, batch["tokens"], batch["cache"], cfg,
                                       prefix_embeds=batch.get("prefix_embeds"))
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return _serving(cfg, decode_step)
