"""Deterministic, resumable epoch pipeline with the paper's ordering
policies (``repro.data.pipeline``). The pipeline state (epoch, cursor,
seed) is tiny and rides in every checkpoint, so a resumed run replays the
same batch sequence.

The permutations are the reference's own: ``np.random.default_rng(seed)``
(shuffle_once) or ``(seed, epoch)`` (shuffle_always), so the port's batch
order equals the reference's index for index. Each batch is gathered on
the data's device (the indices move there, the rows do not move)."""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np
import torch

from repro_torch.core.tree import leaves, tree_map


@dataclasses.dataclass
class PipelineState:
    epoch: int = 0
    cursor: int = 0  # batches already emitted within the epoch
    seed: int = 0

    def to_meta(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_meta(d: dict) -> "PipelineState":
        return PipelineState(**d)


class EpochPipeline:
    """Orders examples per epoch according to a policy:

    * "clustered"      — storage order every epoch (the pathological case)
    * "shuffle_once"   — one fixed permutation drawn from ``seed``
    * "shuffle_always" — a fresh permutation per epoch, from (seed, epoch)
    """

    def __init__(self, data, batch_size: int, *, ordering: str = "shuffle_once"):
        self.data = data
        self.n = int(leaves(data)[0].shape[0])
        self.batch_size = batch_size
        self.ordering = ordering
        if self.n % batch_size:
            raise ValueError(f"n={self.n} not divisible by batch={batch_size}")
        self.batches_per_epoch = self.n // batch_size

    def _perm(self, state: PipelineState) -> np.ndarray:
        if self.ordering == "clustered":
            return np.arange(self.n)
        if self.ordering == "shuffle_once":
            rng = np.random.default_rng(state.seed)
        elif self.ordering == "shuffle_always":
            rng = np.random.default_rng((state.seed, state.epoch))
        else:
            raise ValueError(self.ordering)
        return rng.permutation(self.n)

    def batches(self, state: PipelineState) -> Iterator[Tuple[dict, PipelineState]]:
        """Yields (batch, state-after-batch) from ``state`` onwards, across
        epoch boundaries, indefinitely."""
        while True:
            perm = self._perm(state)
            for b in range(state.cursor, self.batches_per_epoch):
                idx = torch.from_numpy(perm[b * self.batch_size:(b + 1) * self.batch_size])
                batch = tree_map(lambda x: x.index_select(0, idx.to(x.device)), self.data)
                state = PipelineState(state.epoch, b + 1, state.seed)
                yield batch, state
            state = PipelineState(state.epoch + 1, 0, state.seed)
