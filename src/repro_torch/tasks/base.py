"""Task protocol: the ~10-lines-of-code contract from the paper (Fig. 4).

A task defines ``init_model`` and ``example_loss``; ``example_grad`` comes
for free from ``torch.func.grad`` (tasks may override it with a
hand-written gradient, mirroring the paper's hand-coded transitions).
``full_loss`` is the piggybacked objective evaluation used by
convergence tests: one batched evaluation over the whole table."""

from __future__ import annotations

import torch

from repro_torch.core.tree import leaves


def on_devices(make) -> dict:
    """``make(device)`` for the CPU and, where there is one, the current
    CUDA device, keyed by ``str(device)``: a task's constant tensors,
    made when the task is made. Made at first use instead, they could be
    made inside a ``torch.func`` transform (the fold's gradient, the
    segmented lanes' ``vmap``), which wraps what it makes and refuses
    random draws."""
    devices = [torch.device("cpu")]
    if torch.cuda.is_available():
        devices.append(torch.device("cuda", torch.cuda.current_device()))
    return {str(d): make(d) for d in devices}


def constants_on(table: dict, device):
    """The constants of ``table`` (from :func:`on_devices`) on
    ``device``: copied from the CPU's for a device it lacks."""
    found = table.get(str(device))
    if found is None:
        found = tuple(t.to(device) for t in table["cpu"])
    return found


class Task:
    def init_model(self, generator: torch.Generator):
        """The initial model (a tensor or a dict of them), on
        ``generator.device``."""
        raise NotImplementedError

    def example_loss(self, model, example) -> torch.Tensor:
        raise NotImplementedError

    def example_grad(self, model, example):
        return torch.func.grad(self.example_loss)(model, example)

    def regularizer(self, model) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32, device=leaves(model)[0].device)

    def full_loss(self, model, data) -> torch.Tensor:
        per = torch.func.vmap(lambda ex: self.example_loss(model, ex))(data)
        return torch.sum(per) + self.regularizer(model)
