"""Data-ordering policies (paper §3.2 and §4.3).

Inside an RDBMS data is clustered for reasons unrelated to the analysis
(e.g. by class label — the CA-TX example); IGD over such an order converges
pathologically slowly. The paper's fix: shuffle ONCE before the first epoch
(ShuffleOnce) instead of every epoch (ShuffleAlways), trading a slightly
worse per-epoch rate for much lower wall-clock per epoch.

A policy's ``order(data, n, epoch, draw) -> examples`` returns the epoch's
stream; ``draw()`` hands out the run's next permutation
(``RunDraws.permutation`` of ``repro_torch.core.draws``). ``Clustered``
returns the stored order unchanged and draws nothing.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device


def _permute(data, perm):
    return {k: torch.index_select(v, 0, perm) for k, v in data.items()}


@dataclasses.dataclass
class Clustered:
    """The heap order — whatever the storage layer gives us (pathological
    when correlated with labels)."""

    name: str = "clustered"

    def order(self, data, n, epoch, draw):
        del n, epoch, draw
        return data


@dataclasses.dataclass
class ShuffleAlways:
    """Random reshuffle before every epoch (ORDER BY RANDOM() per pass)."""

    name: str = "shuffle_always"

    def order(self, data, n, epoch, draw):
        del n, epoch
        return _permute(data, draw())


def _data_key(data, n: int):
    """Identity key for a table: column object ids + shapes/dtypes.

    Object ids catch "same shape, different table"; shapes catch id reuse
    after the original was freed."""
    return (n,) + tuple(
        (k, id(v), tuple(v.shape), str(v.dtype)) for k, v in sorted(data.items())
    )


@dataclasses.dataclass
class ShuffleOnce:
    """The paper's contribution: permute once, before the first epoch, and
    reuse that order for every pass (no per-epoch reshuffle cost).

    The cached permuted table is keyed on the *incoming data's* identity
    so calling the same policy object with a different table reshuffles
    instead of silently returning the previous table's rows."""

    name: str = "shuffle_once"
    _cache: object = dataclasses.field(default=None, repr=False)
    _cache_key: object = dataclasses.field(default=None, repr=False)

    def order(self, data, n, epoch, draw):
        del epoch
        key = _data_key(data, n)
        if self._cache is None or self._cache_key != key:
            self._cache = _permute(data, draw())
            self._cache_key = key
        return self._cache


def cluster_by_label(data, labels):
    """Adversarially cluster a dataset by class label — constructs the
    paper's pathological order (all +1 examples, then all -1)."""
    order = torch.argsort(-labels, stable=True)
    return _permute(data, order)


def make_catx_dataset(n: int, device=None):
    """The 1-D CA-TX example (paper Example 2.1 / 3.1): 2n points, x_i = 1,
    y_i = +1 for the first n ('California'), -1 for the rest ('Texas').
    ``device=None`` means the CUDA card, and raises without one."""
    f32 = dict(dtype=torch.float32, device=resolve_device(device))
    x = torch.ones((2 * n, 1), **f32)
    y = torch.cat([torch.ones(n, **f32), -torch.ones(n, **f32)])
    return {"x": x, "y": y}


def catx_closed_form(w0: float, alpha: float, n: int):
    """Closed-form iterate after one clustered epoch (paper Appendix C):

        w_{2n} = (1-a)^{2n} w0 - (1-(1-a)^n)^2 - a (1-a)^n
    """
    one = 1.0 - alpha
    return one ** (2 * n) * w0 - (1.0 - one**n) ** 2 - alpha * one**n
