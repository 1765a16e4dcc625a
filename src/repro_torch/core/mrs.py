"""Multiplexed Reservoir Sampling (paper §3.4, Fig. 6).

For data too large to shuffle even once, the paper multiplexes gradient
steps over (a) the streamed data via reservoir displacement and (b) a
buffer holding the previous epoch's reservoir:

  * the **I/O worker** streams tuples, maintains a reservoir in buffer A,
    and takes a gradient step on each *dropped* tuple (the displaced
    reservoir entry, or the rejected incoming tuple);
  * the **memory worker** concurrently cycles over buffer B (last epoch's
    reservoir) taking gradient steps;
  * buffers swap at epoch boundaries.

Per streamed tuple the update sequence is 1 I/O-worker step followed by
``ratio`` memory-worker steps — the two "threads" multiplexed into one
stream of transitions, as the reference does inside one scan.

The reservoir's decisions depend only on the epoch's draws, never on the
model, so :func:`mrs_epoch` works them out for the whole epoch in one
pass on the device (:func:`reservoir_plan`: which row each tuple drops,
which rows end in the reservoir), gathers the epoch's transition rows in
their exact order, and folds them. A tuple's draw ``s_i`` is uniform
over ``range(i + 1)`` (``EpochDraws.reservoir``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core import uda as uda_lib
from repro_torch.core.tracecount import count_build


@dataclasses.dataclass(frozen=True)
class MRSConfig:
    buffer_size: int
    # memory-worker steps per streamed tuple
    ratio: int = 1


def zero_buffer(rows: int, like: dict) -> dict:
    """An empty reservoir of ``rows`` rows of ``like``'s columns, on their
    device."""
    return {k: torch.zeros((rows,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
            for k, v in like.items()}


def reservoir_step(buf, n_seen, example, s):
    """One Vitter reservoir update with the draw ``s`` (uniform over
    ``range(n_seen + 1)``). Returns (buf, dropped_example); ``buf`` is not
    modified in place.

    While filling (n_seen < B) the incoming tuple enters the reservoir and
    is also the 'dropped' tuple used for the I/O worker's gradient step
    (every tuple must contribute a step, as in the plain UDA)."""
    b = next(iter(buf.values())).shape[0]
    n_seen = torch.as_tensor(n_seen)
    s = torch.as_tensor(s)
    filling = n_seen < b
    take = filling | (s < b)
    slot = torch.where(filling, torch.clamp(n_seen, max=b - 1), torch.clamp(s, max=b - 1))
    new_buf, dropped = {}, {}
    for k, v in buf.items():
        displaced = v[slot]
        written = v.clone()
        written[slot] = example[k]
        new_buf[k] = torch.where(take, written, v)
        # dropped = the displaced entry if we inserted (and weren't
        # filling), else the incoming tuple itself
        dropped[k] = torch.where(take & ~filling, displaced, example[k])
    return new_buf, dropped


def reservoir_plan(draws: torch.Tensor, b: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole epoch's reservoir decisions from its draws ``[n]``
    (``draws[i]`` uniform over ``range(i + 1)``), for a reservoir of ``b``
    slots: ``(dropped [n], owner [b])``, int64 on the draws' device.

    ``dropped[i]`` is the stream row the I/O worker steps on for tuple
    ``i`` — ``i`` itself while filling or when the tuple is rejected, else
    the row it displaces. ``owner[j]`` is the stream row in slot ``j`` at
    the end, or -1 where no tuple reached the slot (``b > n``).

    The same as ``n`` calls of :func:`reservoir_step`: a tuple that
    displaces one after the fill (i >= b) finds in its slot the last
    earlier tuple written there, and the fill wrote every slot first, so
    sorting the writes by (slot, i) puts each displaced row just before
    the write that displaces it."""
    n = draws.shape[0]
    i = torch.arange(n, device=draws.device)
    filling = i < b
    take = filling | (draws < b)
    slot = torch.where(filling, torch.clamp(i, max=b - 1), torch.clamp(draws, max=b - 1))
    # writes ordered by (slot, i); rejected tuples after them all
    order = torch.argsort(torch.where(take, slot * n + i, b * n + i))
    prev = torch.cat([order[:1], order[:-1]])
    displaces = (take & ~filling)[order]
    dropped = torch.empty_like(i)
    dropped[order] = torch.where(displaces, prev, order)
    owner = torch.full((b,), -1, dtype=torch.int64, device=draws.device)
    owner = owner.scatter_reduce(0, slot, torch.where(take, i, -1), "amax")
    return dropped, owner


def _refill(buf, stream, owner):
    """The reservoir after an epoch: each slot's owner row of ``stream``,
    or the slot's old entry where no tuple reached it."""
    got = owner >= 0
    src = torch.clamp(owner, min=0)
    out = {}
    for k, v in buf.items():
        rows = torch.index_select(stream[k], 0, src)
        out[k] = torch.where(got.view((-1,) + (1,) * (v.dim() - 1)), rows, v)
    return out


def reservoir_sample(data, buffer_size: int, draws: torch.Tensor):
    """Plain one-pass without-replacement sample (the Subsampling
    baseline) with the stream's draws ``[n]``."""
    _, owner = reservoir_plan(draws, buffer_size)
    return _refill(zero_buffer(buffer_size, data), data, owner)


def mrs_epoch(uda, state, stream, buf_a, buf_b, mem_active: bool, cfg: MRSConfig, draws):
    """One MRS epoch: stream the tuples with the reservoir draws ``draws``
    ``[n]``, multiplexing I/O and memory steps. Returns ``(state, buf_a)``,
    ``buf_a`` the new reservoir. While ``mem_active`` is false (the first
    epoch, when buffer B holds nothing yet) the memory steps are skipped
    entirely — state and step unchanged, as the reference masks them."""
    b = cfg.buffer_size
    if b <= 0:
        raise ValueError(f"MRS needs a buffer of at least one row, got {b}")
    n = draws.shape[0]
    dropped, owner = reservoir_plan(draws, b)
    rows = {k: torch.index_select(v, 0, dropped) for k, v in stream.items()}
    if mem_active and cfg.ratio > 0:
        # the memory worker's pointer runs on across tuples: tuple i's
        # r-th step reads slot (i * ratio + r) mod b of buffer B
        mem = torch.arange(n * cfg.ratio, device=draws.device) % b
        rows = {
            k: torch.cat(
                [v[:, None], torch.index_select(buf_b[k], 0, mem).view((n, cfg.ratio) + tuple(v.shape[1:]))],
                dim=1,
            ).flatten(0, 1)
            for k, v in rows.items()
        }
    state = uda_lib.fold(uda, state, rows)
    return state, _refill(buf_a, stream, owner)


def run_mrs(uda, data, *, generator: torch.Generator, epochs: int, cfg: MRSConfig,
            draws=None, loss_fn=None):
    """Epoch loop with buffer swapping (Fig. 6). Data is streamed in its
    stored (possibly clustered) order — the whole point of MRS is to avoid
    any shuffle. ``draws`` (a ``RunDraws``) gives each epoch's reservoir
    draws; it defaults to a ``TorchDraws`` stream seeded with the
    generator's seed on its device."""
    from repro_torch.core import draws as draws_lib

    n = next(iter(data.values())).shape[0]
    if draws is None:
        draws = draws_lib.TorchDraws().stream(generator.initial_seed(), n, generator.device)
    state = uda.initialize(generator)
    count_build()  # the epoch callable, in the process-wide tally
    zero_buf = zero_buffer(cfg.buffer_size, data)
    buf_a, buf_b = zero_buf, zero_buf
    losses = []
    for epoch in range(1, epochs + 1):
        state, buf_a = mrs_epoch(uda, state, data, buf_a, buf_b, epoch > 1, cfg,
                                 draws.epoch().reservoir())
        buf_a, buf_b = buf_b, buf_a  # swap: memory worker gets fresh reservoir
        if loss_fn is not None:
            losses.append(float(loss_fn(uda.terminate(state), data)))
    return uda.terminate(state), losses
