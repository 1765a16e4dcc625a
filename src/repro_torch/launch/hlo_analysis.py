"""Per-device step analysis for the roofline (``repro.launch.hlo_analysis``).

The reference parses the partitioned HLO text of a compiled step. The
port has no HLO: its dry run (``launch.dryrun``) runs the step once on
fake tensors, and :class:`StepCounter`, a ``TorchDispatchMode``, counts
what one device (rank 0) executes:

* **FLOPs**: every op that ``torch.utils.flop_counter.flop_registry``
  prices (the matmuls), at the shapes of the local tensors;
* **HBM bytes**, the reference's matmul-operand model: for every counted
  matmul its two operands' and its output's bytes, plus twice each
  collective's output bytes (a collective reads and writes HBM). It
  assumes elementwise chains fuse into the matmuls around them, as the
  reference's does;
* **collective bytes by kind** under the reference's kind names
  (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``):
  each collective's output bytes, and in ``collective_traffic_bytes`` an
  all-reduce counted twice (reduce-scatter then all-gather). DTensor's
  bookkeeping ops (``_c10d_functional.wait_tensor``,
  ``_wrap_tensor_autograd``) are no collectives and are not counted;
* **temp bytes**: the peak of the local bytes the step allocates beyond
  what was live when it started (its arguments), from the counter's own
  weakrefs on the outputs' storages.

The mode returns ``NotImplemented`` when a ``DTensor`` is among an op's
types, so it sees only the local ops DTensor runs on each shard, and the
collectives its redistributions issue; ``FlopCounterMode`` would count a
DTensor op at its global shapes. An op not in the registry is decomposed
first, as ``FlopCounterMode`` does, so on one device the two agree
exactly. The counter counts only ops on fake tensors of the dry run's
``FakeTensorMode``: DTensor's shape propagation runs each op once more on
fakes of another mode (its "shadow" ops, on a cache miss), and those must
not count, so a cold and a warm DTensor cache give the same numbers.

**Not applicable**, and why:

* ``analyze`` and its HLO-text parser (``_shape_bytes``, the while-loop
  trip-count weighting): there is no HLO. A dispatch mode sees every op
  that executes, loops included, so nothing needs weighting;
* the ``*_proj`` bf16 projection: the reference's CPU backend computes
  bf16 at f32 width, so it halves such tensors; the fake step runs bf16
  at bf16 width, so each ``_proj`` value equals its raw one (recorded
  under both names, as ``engine.sweep.roofline_summary(projected=True)``
  reads it);
* ``hbm_upper_bytes`` (the sum of every instruction's output): an
  eager step has no fusion boundaries to sum over, so it has no plain
  counterpart.

The roofline (``roofline_terms``, ``dominant``) uses the NVIDIA H100 SXM's
figures in place of the reference's TPU v5e ones.
"""

from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.core.tree import leaves

PEAK_FLOPS = 989e12  # FLOP/s, H100 SXM, dense bf16 on the tensor cores
HBM_BW = 3.35e12  # bytes/s, H100 SXM HBM3
LINK_BW = 450e9  # bytes/s, H100 SXM NVLink 4, one direction (900 GB/s both)

# functional collectives (the ops DTensor's redistributions issue), by the
# reference's kind names; anything else in their namespaces is bookkeeping
_COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_dtensor")

# matmuls of the HBM model: op name -> positions of its two operands
_MATMULS = {"mm": (0, 1), "addmm": (1, 2), "bmm": (0, 1), "baddbmm": (1, 2)}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [x for x in torch.utils._pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def local_tensors(tree) -> list:
    """The tensors of a tree (DTensor leaves as their local shards; other
    leaves, such as a cache's host-side index, dropped)."""
    from repro_torch.dist.sharding import is_dtensor

    return [x.to_local() if is_dtensor(x) else x for x in leaves(tree) if isinstance(x, torch.Tensor)]


def local_bytes(tree) -> int:
    """Bytes of one rank's share of a tree: each tensor's (or DTensor's
    local shard's) elements times their size."""
    return sum(_nbytes(t) for t in local_tensors(tree))


@dataclasses.dataclass
class StepAnalysis:
    flops: float  # matmul FLOPs (per device)
    hbm_bytes: float  # matmul-operand HBM traffic model (per device)
    hbm_bytes_proj: float  # equal to hbm_bytes (see the module's docstring)
    collective_operand_bytes: float
    collective_traffic_bytes: float
    collective_traffic_bytes_proj: float  # equal to collective_traffic_bytes
    collectives_by_kind: dict
    dot_count: int
    temp_bytes: int  # peak local bytes allocated beyond the step's arguments


class StepCounter(TorchDispatchMode):
    """Counts one device's FLOPs, HBM bytes, collectives and peak of
    allocated bytes over the ops run while it is entered (see the module's
    docstring). ``fake_mode``: count only ops touching fake tensors of
    this ``FakeTensorMode``. Call :meth:`hold` with the step's arguments
    first, so their storages are not counted as allocated by the step."""

    def __init__(self, fake_mode):
        super().__init__()
        self.fake_mode = fake_mode
        self.flops = 0
        self.dot_count = 0
        self.matmul_bytes = 0
        self.by_kind = defaultdict(lambda: [0, 0])
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages = WeakIdKeyDictionary()  # storage -> bytes counted
        try:
            from torch.distributed.tensor import DTensor
        except ImportError:  # a torch built without distributed
            DTensor = None
        self._dtensor = DTensor

    def hold(self, tree) -> None:
        """Mark the storages of ``tree``'s tensors as live before the step."""
        for t in local_tensors(tree):
            self._storages.setdefault(t.untyped_storage(), 0)

    def _free(self, nbytes: int) -> None:
        self.live_bytes -= nbytes

    def _ours(self, tensors) -> bool:
        return any(getattr(t, "fake_mode", None) is self.fake_mode for t in tensors)

    def _allocated(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            if st in self._storages:
                continue
            n = st.nbytes()
            self._storages[st] = n
            weakref.finalize(st, self._free, n)
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if self._dtensor is not None and any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        packet = func._overloadpacket
        if packet not in flop_registry and func is not torch.ops.prim.device.default:
            with self:  # as FlopCounterMode: price what the op decomposes into
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if not self._ours(_tensors((args, kwargs, out))):
            return out
        self._allocated(out)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        name = packet.__name__
        if name in _MATMULS:
            lhs, rhs = (args[i] for i in _MATMULS[name])
            self.dot_count += 1
            self.matmul_bytes += _nbytes(lhs) + _nbytes(rhs) + _nbytes(out)
        elif name in _COLLECTIVE_KINDS and func.namespace in _COLLECTIVE_NAMESPACES:
            entry = self.by_kind[_COLLECTIVE_KINDS[name]]
            entry[0] += 1
            entry[1] += sum(_nbytes(t) for t in _tensors(out))
        return out

    def analysis(self) -> StepAnalysis:
        operand = sum(b for _, b in self.by_kind.values())
        traffic = sum(b * (2 if kind == "all-reduce" else 1) for kind, (_, b) in self.by_kind.items())
        hbm = self.matmul_bytes + 2 * operand
        return StepAnalysis(
            flops=float(self.flops),
            hbm_bytes=float(hbm),
            hbm_bytes_proj=float(hbm),
            collective_operand_bytes=float(operand),
            collective_traffic_bytes=float(traffic),
            collective_traffic_bytes_proj=float(traffic),
            collectives_by_kind={k: {"count": c, "bytes": b} for k, (c, b) in sorted(self.by_kind.items())},
            dot_count=self.dot_count,
            temp_bytes=int(self.peak_bytes),
        )


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------


def roofline_terms(
    flops_per_device: float,
    bytes_per_device: float,
    collective_bytes_per_device: float,
    *,
    n_links: int = 1,
):
    """The three roofline terms (seconds) for one step on one card."""
    return {
        "compute_s": flops_per_device / PEAK_FLOPS,
        "memory_s": bytes_per_device / HBM_BW,
        "collective_s": collective_bytes_per_device / (LINK_BW * n_links),
    }


def dominant(terms: dict) -> str:
    return max(
        ("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k]
    ).replace("_s", "")


def model_flops(cfg, shape, n_params_total: int, n_params_active: int) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (prefill) / 2*N*B (decode)."""
    if shape.kind == "train":
        return 6.0 * n_params_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_params_active * shape.global_batch * shape.seq_len
    return 2.0 * n_params_active * shape.global_batch


def count_params(params, cfg):
    """(total, active) elements of a param tree (``lm.init_lm``'s, meta
    tensors do): every leaf under a ``"moe"`` key but its router counts
    top_k/E toward the active params. The port's per-layer lists hold the
    same elements as the reference's stacked leaves."""
    total = 0
    expert = 0

    def walk(tree, names):
        nonlocal total, expert
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], names + (k,))
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v, names)
        else:
            n = tree.numel()
            total += n
            if "moe" in names and names[-1] != "router":
                expert += n

    walk(params, ())
    if cfg.n_experts:
        active = total - expert + expert * cfg.top_k / cfg.n_experts
    else:
        active = total
    return total, active
