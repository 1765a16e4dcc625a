"""Variant sweeps: the engine's generic "try configurations, record
outcomes" driver (the reference's ``repro.engine.sweep``).

Offline studies need the same loop: run a list of tagged variants
through a runner, append one JSON record per variant to a log (never
losing completed work to a later failure), and print a one-line status.
"""

from __future__ import annotations

import json
import traceback
from typing import Callable, Optional, Sequence, Tuple

# A variant: (arch, shape, runner_kwargs, cfg_overrides, tag)
Variant = Tuple[str, str, dict, Optional[dict], str]


def sweep(
    run_fn: Callable[..., dict],
    variants: Sequence[Variant],
    out_path: str,
    *,
    only: Optional[str] = None,
    summarize: Optional[Callable[[dict], str]] = None,
    log_fn: Callable[[str], None] = print,
) -> list:
    """Run each variant through ``run_fn(arch, shape, cfg_overrides=...,
    tag=..., **kwargs)``, appending each record to ``out_path`` as it
    completes. Failures become FAIL records, not aborts. Returns records.

    ``summarize(rec) -> str`` customizes the per-variant status line."""
    records = []
    with open(out_path, "a") as f:
        for arch, shape, kwargs, overrides, tag in variants:
            if only and only not in tag:
                continue
            try:
                rec = run_fn(arch, shape, cfg_overrides=overrides, tag=tag, **kwargs)
            except Exception as e:  # noqa: BLE001 — record and continue
                rec = {
                    "arch": arch,
                    "shape": shape,
                    "tag": tag,
                    "status": "FAIL",
                    "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-1500:],
                }
            f.write(json.dumps(rec) + "\n")
            f.flush()
            extra = f" {summarize(rec)}" if summarize else ""
            log_fn(f"{tag} {rec.get('status')}{extra}")
            records.append(rec)
    return records


def roofline_summary(rec: dict, *, projected: bool = False) -> str:
    """The hillclimb status line of a dry-run record: its collective,
    memory and compute terms in seconds (``launch.hlo_analysis.
    roofline_terms``, at one H100 SXM's figures where the reference's line
    uses a TPU v5e's) and its temp GiB."""
    from repro_torch.launch.hlo_analysis import roofline_terms

    suffix = "_proj" if projected else ""
    terms = roofline_terms(rec.get("hlo_flops") or 0, rec.get(f"hlo_hbm_bytes{suffix}") or 0,
                           rec.get(f"collective_traffic_bytes{suffix}") or 0)
    return (
        f"coll {round(terms['collective_s'], 1)} "
        f"mem {round(terms['memory_s'], 1)} "
        f"comp {round(terms['compute_s'], 1)} "
        f"temp_gb {round((rec.get('temp_bytes') or 0) / 2**30, 1)}"
    )
