"""Serving entry points (``repro.launch.serve``).

Two serving surfaces share this module:

* **Analytics serving**: the engine's serving front end
  (``repro_torch.engine.serve``) — ``make_analytics_server`` builds a
  ``ServingEngine`` (admission control + cross-query batching + optional
  persistent plan cache) and ``serve_analytics`` runs a submit-and-drain
  load, returning the tickets.
* **LM serving**: batched prefill and KV-cache decode step builders with
  the reference's batch dicts. Each builder makes the compute-dtype copy
  of the params once (``lm.cast_params``) and reuses it while it is
  called with the same params object: the reference casts float32 params
  at every use, which on the card would read 12.85 GB and write 6.4 GB
  per llama3.2-3b decode step.

The reference's ``trace_dir``/``obs_port`` (span traces and the metrics
server) and its SLO rules come with the port's obs slice.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import torch

from repro_torch.engine import executor, serve as serve_lib
from repro_torch.models import lm


def make_analytics_server(
    *,
    cache_dir: Optional[str] = None,
    max_queue: int = 64,
    max_per_task: int = 32,
    max_batch: int = 8,
    device=None,
) -> serve_lib.ServingEngine:
    """An analytics ``ServingEngine`` with the given admission knobs, over
    an engine on ``device`` (None: the CUDA card)."""
    config = serve_lib.ServeConfig(
        max_queue=max_queue, max_per_task=max_per_task, max_batch=max_batch,
        cache_dir=cache_dir,
    )
    return serve_lib.ServingEngine(config, engine=executor.Engine(device=device))


def serve_analytics(
    queries: Iterable,
    *,
    server: Optional[serve_lib.ServingEngine] = None,
    **server_kw,
) -> List[serve_lib.Ticket]:
    """Submit ``queries`` (admission-controlled), drain the queue, and
    return one ticket per query — rejected ones carry ``reject_reason``
    instead of a result."""
    srv = server if server is not None else make_analytics_server(**server_kw)
    tickets = [srv.submit(q) for q in queries]
    srv.drain()
    return tickets


def _cast_once(cfg):
    held = {}

    def cast(params):
        if held.get("source") is not params:
            held.clear()  # drop the old copy before making the new one
            held["cast"], held["source"] = lm.cast_params(params, cfg), params
        return held["cast"]

    return cast


def make_prefill_step(cfg):
    cast = _cast_once(cfg)

    def prefill_step(params, batch):
        """batch: {"tokens": [B, S]} -> last-position logits [B, vocab]."""
        return lm.prefill(cast(params), batch["tokens"], cfg,
                          prefix_embeds=batch.get("prefix_embeds"))

    return prefill_step


def make_decode_step(cfg):
    cast = _cast_once(cfg)

    def decode_step(params, batch):
        """batch: {"tokens": [B, S], "cache": ...} -> (greedy next token
        [B] int32, cache). With the whole prompt at cache index 0 this
        prefills into the cache."""
        logits, cache = lm.decode_step(cast(params), batch["tokens"], batch["cache"], cfg)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return decode_step
