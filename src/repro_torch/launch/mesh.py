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

The LM stack's meshes (``dist.sharding``'s policy reads only their axis
sizes, so it takes either kind):

* ``make_host_mesh(data, model)`` — a ``DeviceMesh`` with dims ("data",
  "model") over the ranks of the process group (one process a device:
  gloo on the CPU, NCCL on the card). It raises when the world size is
  not ``data * model``. A world of one needs no launcher:
  :func:`init_world` builds its group from a ``HashStore``;
* ``make_production_mesh(multi_pod)`` — the reference's (16, 16) ("data",
  "model") or (2, 16, 16) ("pod", "data", "model") mesh as an
  :class:`AbstractMesh`: axis names and sizes, no devices (the sharding
  policy's tests read it);
* ``fake_mesh(shape)`` — a context: that mesh as a ``DeviceMesh`` on
  ``"cpu"`` over a fake process group of ``prod(shape)`` ranks in this
  process (PyTorch's ``"fake"`` backend: this process is rank 0, and a
  collective moves nothing but gives outputs of the right shapes). The
  dry run's mesh (``launch.dryrun``); the group is destroyed when the
  context ends, failed or not.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

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


# ---------------------------------------------------------------------------
# LM meshes (repro_torch.dist.sharding)
# ---------------------------------------------------------------------------


class AbstractMesh:
    """A mesh's axis names and sizes, with no devices behind it: ``shape``
    is ``{axis: size}`` in axis order, as a JAX mesh's is."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The reference's production mesh, abstract: 256 devices a pod as
    (data=16, model=16); multi-pod adds a leading pod axis (2, 16, 16)."""
    if multi_pod:
        return AbstractMesh({"pod": 2, "data": 16, "model": 16})
    return AbstractMesh({"data": 16, "model": 16})


def init_world(backend: Optional[str] = None, device=None) -> None:
    """A process group of one rank from a ``HashStore`` (no launcher, no
    network), unless one is up already. The backend follows ``device``
    (``resolve_device``): NCCL on the card, gloo on the CPU."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """A ("data", "model") ``DeviceMesh`` over the process group's ranks
    (rank r at data r // model, model r % model), on ``device``'s kind (the
    card unless ``"cpu"``). The group must be up (``init_world`` for one
    rank, ``torchrun`` or ``init_process_group`` for more)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs a process group: call init_world() for one rank, "
                           "or start the ranks with torchrun")
    world = dist.get_world_size()
    if world != data * model:
        raise ValueError(f"a ({data}, {model}) mesh needs data x model = {data * model} ranks, "
                         f"but the process group has {world}")
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return init_device_mesh(device.type, (data, model), mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def fake_mesh(shape: Dict[str, int]):
    """A ``DeviceMesh`` of ``shape`` ({axis: size}, in axis order) on
    ``"cpu"`` over a fake process group of ``prod(sizes)`` ranks, this
    process rank 0; the group is destroyed on exit. No process group may
    be up already."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    # registers the "fake" backend (PyTorch ships it with its test helpers)
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_mesh needs no process group to be up: it starts its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(shape.values()))
    try:
        yield init_device_mesh("cpu", tuple(shape.values()), mesh_dim_names=tuple(shape))
    finally:
        dist.destroy_process_group()
