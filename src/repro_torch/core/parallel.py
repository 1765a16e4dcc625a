"""Parallel IGD schemes (paper §3.3).

The paper studies two in-RDBMS parallelization mechanisms:

* **Pure UDA (shared-nothing)** — partial models trained per data segment,
  combined with ``merge`` (model averaging). Provided by
  ``repro_torch.core.uda.segmented_fold``.

* **Shared-memory UDA** — one model concurrently updated by many workers
  with three concurrency schemes: ``Lock`` (model mutex), ``AIG``
  (per-component CompareAndExchange; Niu et al.'s atomic variant) and
  ``NoLock`` (Hogwild!). This module is a faithful *statistical
  simulator* of the three interleavings on one device — stale reads of
  bounded staleness (window = #workers) and, for NoLock, lost component
  updates — to reproduce the paper's Figure 9(A) convergence comparison,
  not to be fast.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import igd as igd_lib, tree
from repro_torch.core.tracecount import count_build


@dataclasses.dataclass(frozen=True)
class SharedMemoryConfig:
    scheme: str = "nolock"  # "lock" | "aig" | "nolock"
    workers: int = 8
    # Probability a component write is overwritten by a racing worker
    # (NoLock only). Scaled by (workers-1)/workers so 1 worker == serial.
    lost_update_rate: float = 0.05

    def keep_probability(self) -> float:
        """The chance a NoLock component write survives."""
        p = self.workers
        return 1.0 - self.lost_update_rate * (p - 1) / max(p, 1)


def hogwild_draws(epoch_draws, cfg: SharedMemoryConfig, d: int
                  ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The epoch's ``(read_versions [n, d], kept_writes [n, d])`` that
    ``cfg.scheme`` uses (None where it uses none: lock reads the fresh
    model, only nolock loses writes)."""
    versions = keep = None
    if cfg.scheme != "lock":
        versions = epoch_draws.read_versions(d, cfg.workers)
    if cfg.scheme == "nolock":
        keep = epoch_draws.kept_writes(d, cfg.keep_probability())
    return versions, keep


def hogwild_fold(task, step_size, model, examples, cfg: SharedMemoryConfig,
                 versions=None, keep=None, prox=None):
    """Simulate one epoch of shared-memory parallel IGD.

    The model (a tensor or a dict of them) is raveled to one vector of
    ``d`` components (``core.tree.ravel``: sorted-key order, as the
    reference's ``ravel_pytree``) and unraveled for each gradient and each
    prox. Carry: a ring of the last ``workers`` raveled model versions. At
    step k a worker reads a stale model:
      * lock   — staleness 0 (serial; the mutex serializes read+write),
      * aig    — component j is read from ``versions[k, j]`` versions back
                 in the window (mixed-version reads; writes never lost),
      * nolock — same mixed-version reads, and component j of the write
                 is lost where ``keep[k, j]`` is false.
    The update is applied to the freshest model (hogwild writes to the
    live shared buffer), then the prox. Step sizes restart at step 0
    every call, as in the reference's simulator.
    """
    if cfg.scheme not in ("lock", "aig", "nolock"):
        raise ValueError(f"unknown shared-memory scheme {cfg.scheme!r}")
    prox = prox or igd_lib.identity_prox
    p = cfg.workers
    flat, unravel = tree.ravel(model)
    d = flat.shape[0]
    n = next(iter(examples.values())).shape[0]
    ring = flat[None, :].repeat(p, 1)
    cols = torch.arange(d, device=flat.device)
    alphas = step_size(torch.arange(n, dtype=torch.int32, device=flat.device))
    ptr = 0
    for k in range(n):
        fresh = ring[ptr]
        if cfg.scheme == "lock":
            read = fresh
        else:
            read = ring[(ptr - versions[k]) % p, cols]
        alpha = alphas[k]
        g = task.example_grad(unravel(read), {name: v[k] for name, v in examples.items()})
        upd = -alpha * tree.ravel(g)[0]
        if cfg.scheme == "nolock":
            upd = torch.where(keep[k], upd, torch.zeros_like(upd))
        new = tree.ravel(prox(unravel(fresh + upd), alpha))[0]
        ptr = (ptr + 1) % p
        ring[ptr] = new
    return unravel(ring[ptr].clone())


def run_shared_memory(task, step_size, data, *, generator: torch.Generator, epochs: int,
                      cfg: SharedMemoryConfig, draws=None, loss_fn=None, prox=None,
                      ordering=None):
    """Epoch loop around :func:`hogwild_fold` (mirrors ``uda.run_igd``).
    ``draws`` (a ``RunDraws``) gives the ordering's permutations and each
    epoch's hogwild draws; it defaults to a ``TorchDraws`` stream seeded
    with the generator's seed on its device."""
    from repro_torch.core import draws as draws_lib, ordering as ordering_lib

    ordering = ordering or ordering_lib.ShuffleOnce()
    model = task.init_model(generator)
    n = next(iter(data.values())).shape[0]
    if draws is None:
        draws = draws_lib.TorchDraws().stream(generator.initial_seed(), n, generator.device)
    count_build()  # the epoch callable, in the process-wide tally
    losses = []
    for epoch in range(1, epochs + 1):
        examples = ordering.order(data, n, epoch, draws.permutation)
        versions, keep = hogwild_draws(draws.epoch(), cfg, tree.size(model))
        model = hogwild_fold(task, step_size, model, examples, cfg, versions, keep, prox)
        if loss_fn is not None:
            losses.append(float(loss_fn(model, data)))
    return model, losses
