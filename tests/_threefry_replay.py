"""A draw source for the port (``repro_torch.core.draws.DrawSource``) that
replays the JAX package's threefry streams, so a port run starts from the
initial model and draws exactly the permutations, reservoir draws and
hogwild draws its reference run draws, in the order the reference
consumes them.

The initial model is the reference task's ``init_model`` of the
executor's init key, ``PRNGKey(seed)`` (``program.seed_streams(seed)[0]``):
the reference task is the class of the port task's name, built from the
port task's fields.

The reference derives a run's stream key from ``PRNGKey(seed)`` (folded
with a salt: ``PERM_STREAM_SALT`` in the executor and ``run_igd``, 7 in
``run_shared_memory``, none in ``run_mrs``). Each shuffle splits the key
``(key, sub)`` and permutes with ``sub``; each scheme epoch splits it
``(key, sub)`` and hands ``sub`` to the epoch, which splits it once per
row (``mrs.py`` and ``parallel.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import tasks as ref_tasks
from repro.engine.program import PERM_STREAM_SALT, seed_streams


def _torch(a, device):
    return torch.tensor(np.asarray(a), device=device)


class ThreefryReplay:
    def __init__(self, salt=PERM_STREAM_SALT):
        self.salt = salt

    def stream(self, seed, n, device):
        key = jax.random.PRNGKey(seed)
        if self.salt is not None:
            key = jax.random.fold_in(key, self.salt)
        return _Run(key, n, device, seed)


def reference_task(task):
    """The JAX package's task of the same class and fields as ``task``."""
    fields = {f.name: getattr(task, f.name) for f in dataclasses.fields(task) if f.init}
    return getattr(ref_tasks, type(task).__name__)(**fields)


class _Run:
    def __init__(self, key, n, device, seed=0):
        self.key, self.n, self.device, self.seed = key, n, device, seed

    def initial_model(self, task):
        model = reference_task(task).init_model(seed_streams(self.seed)[0])
        return jax.tree.map(lambda a: _torch(a, self.device), model)

    def permutation(self):
        self.key, sub = jax.random.split(self.key)
        return _torch(jax.random.permutation(sub, self.n), self.device).long()

    def epoch(self):
        self.key, sub = jax.random.split(self.key)
        return _Epoch(sub, self.n, self.device)


class _Epoch:
    def __init__(self, key, n, device):
        self.keys = jax.random.split(key, n)
        self.n, self.device = n, device

    def reservoir(self):
        # mrs.reservoir_step: randint(key_i, (), 0, max(seen + 1, 1)), seen = i
        s = jax.vmap(lambda k, hi: jax.random.randint(k, (), 0, hi))(
            self.keys, jnp.arange(1, self.n + 1, dtype=jnp.int32))
        return _torch(s, self.device).long()

    def read_versions(self, d, workers):
        # parallel.hogwild_fold: k_read, k_lost = split(key_i)
        v = jax.vmap(lambda k: jax.random.randint(jax.random.split(k)[0], (d,), 0, workers))(self.keys)
        return _torch(v, self.device).long()

    def kept_writes(self, d, keep):
        b = jax.vmap(lambda k: jax.random.bernoulli(jax.random.split(k)[1], keep, (d,)))(self.keys)
        return _torch(b, self.device)
