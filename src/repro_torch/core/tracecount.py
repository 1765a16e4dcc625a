"""The shared build counter.

PyTorch runs eagerly, so there is no trace to count: what a warm repeat
query must not repeat is *building* the epoch callable of its plan. Every
epoch callable the engine builds goes through :func:`count_build`, which
bumps the plan's own counter and the process-wide tally ``GLOBAL``.
``EngineResult.trace_count`` reads the per-plan counter, so a repeat
query that hits the compiled-plan cache shows the same count as the
first.
"""

from __future__ import annotations

from typing import Dict, Optional

# Process-wide build tally across every counted callable. Mutated in
# place (never rebound) so importers can hold a reference.
GLOBAL: Dict[str, int] = {"traces": 0}


def fresh_counter() -> Dict[str, int]:
    return {"traces": 0}


def count_build(counter: Optional[Dict[str, int]] = None) -> None:
    """Record that an epoch callable was built (the eager analogue of a
    retrace) in ``counter`` and in the process-wide tally."""
    GLOBAL["traces"] += 1
    if counter is not None:
        counter["traces"] += 1
