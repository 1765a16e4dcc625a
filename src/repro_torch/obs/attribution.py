"""Tail-latency attribution: the critical path through a span tree (the
port's copy of ``repro.obs.attribution``).

A p99 breach report that says "latency was 80 ms" is a number; one that
says "62%% execute, 21%% compile, 11%% queue-wait" is a diagnosis. This
module takes exported span records (the tracer's or the flight ring's
plain dicts), rebuilds the parent/child tree, walks the **critical
path** — from a root span, repeatedly descend into the longest child —
and charges each on-path span's *self* time (its duration minus the
on-path child it delegated to) to a phase:

====================  =======================================
phase                 span names
====================  =======================================
``queue_wait``        the root's ``queue_wait_s`` attribute
                      (admission wait is not a span — the
                      serving pump stamps it on its group span)
``assemble``          ``serve.assemble``, ``shard.place``,
                      ``engine.materialize``
``compile``           ``engine.compile``, ``program.build``,
                      ``probe.calibrate``
``execute``           ``serve.execute``, ``epoch``,
                      ``shard.block``, ``engine.loss``
``merge``             ``shard.merge``
``other``             everything else (incl. root self time)
====================  =======================================

``attribute()`` returns a :class:`PhaseReport` with per-phase seconds
and shares; ``engine.explain_analyze`` embeds it in the drift report
and the obs server's ``/snapshot`` endpoint publishes it for the flight
ring's last-N window.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

PHASES = ("queue_wait", "assemble", "compile", "execute", "merge", "other")

PHASE_OF = {
    "serve.assemble": "assemble",
    "shard.place": "assemble",
    "engine.materialize": "assemble",
    "engine.compile": "compile",
    "program.build": "compile",
    "probe.calibrate": "compile",
    "serve.execute": "execute",
    "epoch": "execute",
    "shard.block": "execute",
    "engine.loss": "execute",
    "shard.merge": "merge",
}


def critical_path(
    spans: Sequence[dict], root_name: Optional[str] = None
) -> List[dict]:
    """The chain root -> longest child -> its longest child -> ... .

    ``root_name`` picks the root span by name (the longest such span —
    a trace may hold many ``serve.pump`` groups); otherwise the longest
    parentless span wins. Empty list when there is no root."""
    roots = [
        s for s in spans
        if (s["name"] == root_name if root_name is not None
            else s.get("parent") is None)
    ]
    if not roots:
        return []
    root = max(roots, key=lambda s: s["dur"])
    children: Dict[int, List[dict]] = {}
    for s in spans:
        parent = s.get("parent")
        if parent is not None:
            children.setdefault(parent, []).append(s)
    path = [root]
    node = root
    while True:
        kids = children.get(node["id"])
        if not kids:
            return path
        node = max(kids, key=lambda s: s["dur"])
        path.append(node)


@dataclasses.dataclass(frozen=True)
class PhaseReport:
    """Critical-path phase decomposition of one span tree."""

    root: str
    total_s: float  # root duration + queue wait
    phase_s: Dict[str, float]
    path: Tuple[Tuple[str, float], ...]  # (name, dur) down the chain

    def share(self, phase: str) -> float:
        return self.phase_s.get(phase, 0.0) / self.total_s \
            if self.total_s > 0 else 0.0

    def describe(self) -> str:
        parts = [
            f"{phase} {self.share(phase):.0%}"
            for phase in PHASES
            if self.phase_s.get(phase, 0.0) > 0
        ]
        chain = " > ".join(name for name, _ in self.path)
        return (
            f"critical path ({self.total_s * 1e3:.2f} ms): "
            + (" / ".join(parts) if parts else "no attributable time")
            + f"  [{chain}]"
        )

    def to_dict(self) -> dict:
        return {
            "root": self.root,
            "total_s": self.total_s,
            "phase_s": dict(self.phase_s),
            "path": [list(p) for p in self.path],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PhaseReport":
        return cls(
            root=d["root"],
            total_s=d["total_s"],
            phase_s=dict(d["phase_s"]),
            path=tuple((n, dur) for n, dur in d["path"]),
        )


def attribute(
    spans: Sequence[dict], root_name: Optional[str] = None
) -> Optional[PhaseReport]:
    """Phase attribution along the critical path; None without a root.

    Each on-path span is charged its SELF time — duration minus the
    on-path child's duration (the child's share is charged where it
    belongs, deeper down). Sibling spans off the path are deliberately
    not charged: the critical path is what bounds the latency; work
    that overlapped it did not lengthen it."""
    path = critical_path(spans, root_name)
    if not path:
        return None
    root = path[0]
    phase_s: Dict[str, float] = {}
    for i, span in enumerate(path):
        child_dur = path[i + 1]["dur"] if i + 1 < len(path) else 0.0
        self_s = max(span["dur"] - child_dur, 0.0)
        phase = PHASE_OF.get(span["name"], "other")
        phase_s[phase] = phase_s.get(phase, 0.0) + self_s
    queue_wait = float(root.get("attrs", {}).get("queue_wait_s") or 0.0)
    if queue_wait > 0:
        phase_s["queue_wait"] = phase_s.get("queue_wait", 0.0) + queue_wait
    return PhaseReport(
        root=root["name"],
        total_s=root["dur"] + queue_wait,
        phase_s=phase_s,
        path=tuple((s["name"], s["dur"]) for s in path),
    )
