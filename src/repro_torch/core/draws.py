"""Where a run's random draws come from.

Every random choice a run makes comes from one injectable source, so a
test can replay another implementation's streams in the order the run
consumes them:

* the initial model (random for ``lmf``, and for ``crf`` with
  ``init_scale > 0``; the task's own ``init_model``);
* the orderings' permutations (``ShuffleOnce`` / ``ShuffleAlways``, §3.2);
* each epoch's reservoir draws (buffered MRS, §3.4);
* each epoch's shared-memory draws (which model version each component
  is read from, and which component writes survive; §3.3).

``DrawSource.stream(seed, n, device)`` opens a run over an ``n``-row
table and returns its :class:`RunDraws`. The run takes its initial model
first, from a stream of its own. Within an epoch the run takes
its permutation (if its ordering draws one) first, then ``epoch()``
once, and the scheme's draws from what ``epoch()`` returned — the order
in which the reference executor splits its key.

A fused batch of B queries (the serving front end) opens one run's draws
per lane (:func:`lane_streams`): lane i's stream is the one its singleton
``Engine.run`` would open, so it takes exactly the permutations its
singleton run takes, and a lane whose epoch budget is spent cannot shift
another lane's draws. (The reference batches its threefry splits with
``vmap``, which equals its per-query streams for the same reason.)
"""

from __future__ import annotations

from typing import Protocol

import torch

from repro_torch.core.tree import tree_map

# randint's bound for reservoir draws: one 62-bit draw taken mod (i + 1);
# the bias, at most n / 2**62, is far below anything a run can see
_RESERVOIR_BITS = 2**62


class EpochDraws(Protocol):
    """One epoch's draws for the scheme, each a tensor on the run's
    device covering the whole epoch."""

    def reservoir(self) -> torch.Tensor:
        """int64 [n]: draw i is uniform over ``range(i + 1)`` — the slot
        Vitter's reservoir offers the (i+1)-th streamed tuple."""
        ...

    def read_versions(self, d: int, workers: int) -> torch.Tensor:
        """int64 [n, d], uniform over ``range(workers)``: how many model
        versions back each component of row i's read lies."""
        ...

    def kept_writes(self, d: int, keep: float) -> torch.Tensor:
        """bool [n, d], each True with probability ``keep``: which
        components of row i's update survive a racing writer."""
        ...


class RunDraws(Protocol):
    def initial_model(self, task):
        """``task``'s initial model (a tensor or a dict of them) on the
        run's device."""
        ...

    def permutation(self) -> torch.Tensor:
        """The next int64 permutation of ``range(n)``."""
        ...

    def epoch(self) -> EpochDraws:
        """Open the next epoch's scheme draws (called once an epoch, after
        the ordering has drawn)."""
        ...


class DrawSource(Protocol):
    def stream(self, seed: int, n: int, device: torch.device) -> RunDraws: ...


def lane_streams(source: DrawSource, seeds, n: int, device: torch.device) -> list:
    """One ``RunDraws`` per lane of a fused batch, lane i seeded with
    ``seeds[i]``: each the stream its query's singleton run opens."""
    return [source.stream(seed, n, device) for seed in seeds]


class TorchDraws:
    """The default source: one ``torch.Generator`` on the run's device,
    seeded with the query's seed, hands out every draw of the run; the
    initial model is ``task.init_model`` of another generator seeded
    alike."""

    def stream(self, seed: int, n: int, device: torch.device) -> "_TorchRun":
        return _TorchRun(seed, n, torch.device(device))


def _seeded(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


class _TorchRun:
    def __init__(self, seed: int, n: int, device: torch.device):
        self.seed, self.n, self.device = seed, n, device
        self.gen = _seeded(seed, device)

    def initial_model(self, task):
        return task.init_model(_seeded(self.seed, self.device))

    def permutation(self) -> torch.Tensor:
        return torch.randperm(self.n, generator=self.gen, device=self.device)

    def epoch(self) -> "_TorchRun":
        return self  # the epoch's draws come from the same generator

    def reservoir(self) -> torch.Tensor:
        raw = torch.randint(0, _RESERVOIR_BITS, (self.n,), generator=self.gen, device=self.device)
        return raw % torch.arange(1, self.n + 1, device=self.device)

    def read_versions(self, d: int, workers: int) -> torch.Tensor:
        return torch.randint(0, workers, (self.n, d), generator=self.gen, device=self.device)

    def kept_writes(self, d: int, keep: float) -> torch.Tensor:
        return torch.rand((self.n, d), generator=self.gen, device=self.device) < keep


class HostDraws:
    """``TorchDraws`` made on the CPU and moved to the run's device: the
    same values whichever device the run is on, which is how a run on the
    card is held to the same run on the CPU."""

    def stream(self, seed: int, n: int, device: torch.device) -> "_Moved":
        return _Moved(TorchDraws().stream(seed, n, torch.device("cpu")), torch.device(device))


class _Moved:
    def __init__(self, run, device: torch.device):
        self.run, self.device = run, device

    def initial_model(self, task):
        return tree_map(lambda t: t.to(self.device), self.run.initial_model(task))

    def permutation(self) -> torch.Tensor:
        return self.run.permutation().to(self.device)

    def epoch(self) -> "_Moved":
        return _Moved(self.run.epoch(), self.device)

    def reservoir(self) -> torch.Tensor:
        return self.run.reservoir().to(self.device)

    def read_versions(self, d: int, workers: int) -> torch.Tensor:
        return self.run.read_versions(d, workers).to(self.device)

    def kept_writes(self, d: int, keep: float) -> torch.Tensor:
        return self.run.kept_writes(d, keep).to(self.device)
