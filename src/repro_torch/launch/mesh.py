"""The devices a sharded plan is laid out over.

The counterpart of ``repro.launch.mesh``'s shard meshes. A sharded plan
(``parallelism="sharded"``, ``repro_torch.engine.shard``) places its k
shared-nothing segments on the first d devices of the engine's kind, k/d
kernel (or vmap) lanes on each, and one process drives them all (single
controller, as the reference's ``shard_map`` is):

* ``shard_device_count(device)`` — the devices of the engine's kind:
  ``torch.cuda.device_count()`` on the card, and on the CPU the number of
  virtual CPU devices this process asked for (1 unless
  :func:`force_host_device_count` raised it);
* ``shard_devices(d, device)`` — the first d of them, starting at the
  engine's own device; it raises when fewer exist;
* ``force_host_device_count(count)`` — the process-level virtual CPU
  device count, the counterpart of the reference's
  ``--xla_force_host_platform_device_count``. The virtual devices are all
  the one CPU: they place nothing elsewhere, but a plan over d of them
  runs the merge tree of d devices (each device folds its own lanes, then
  the d partials are merged), so the placement's float association is
  the reference's. Tests use it; it reads and writes no environment
  variable. The reference's ``XLA_FLAGS`` editing
  (``forced_host_device_count``, ``override``, ``env``) and its check
  that the XLA backend is not yet up are **not applicable**: PyTorch has
  no backend to bring up, and the count can change at any time.

Not ported here: ``make_production_mesh`` and ``make_host_mesh``, the
LM stack's (data, model) TPU meshes, come with the rest of the LM stack
(ROADMAP queue 1 item 7).
"""

from __future__ import annotations

from typing import List

import torch

from repro_torch.device import resolve_device

_HOST = {"devices": 1}


def force_host_device_count(count: int) -> int:
    """Set the number of virtual CPU devices a sharded plan on the CPU may
    use; returns it. ``force_host_device_count(1)`` restores the default."""
    if not isinstance(count, int) or count < 1:
        raise ValueError(f"a host device count must be an int >= 1, got {count!r}")
    _HOST["devices"] = count
    return count


def shard_device_count(device=None) -> int:
    """Devices available to the sharded execution subsystem on
    ``device``'s kind (``None``: the card)."""
    device = resolve_device(device)
    if device.type == "cuda":
        return torch.cuda.device_count()
    return _HOST["devices"]


def shard_devices(num_devices: int, device=None) -> List[torch.device]:
    """The first ``num_devices`` devices of ``device``'s kind, ``device``
    first (on the card: the next indices after it, wrapping around; on
    the CPU: ``num_devices`` virtual devices, all the one CPU)."""
    device = resolve_device(device)
    have = shard_device_count(device)
    if num_devices < 1 or num_devices > have:
        raise ValueError(
            f"requested a {num_devices}-device shard mesh but only "
            f"{have} device(s) exist"
        )
    if device.type == "cuda":
        return [torch.device("cuda", (device.index + i) % have) for i in range(num_devices)]
    return [device] * num_devices
