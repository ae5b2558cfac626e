#
# The span tree of a run: `span_tree` of spark_rapids_ml_tpu/telemetry/
# report.py.  The serving server's slow-request capture nests a batch's
# recorded spans with it.  The rest of that module (the per-fit
# `FitTelemetry` report) is not ported yet (ROADMAP.md section 1, item 6).
#
from __future__ import annotations

from typing import Any, Dict, List


def span_tree(events: List[Any]) -> List[Dict[str, Any]]:
    """Nest the run's events into a start-ordered tree keyed off each
    span's recorded depth (instant markers attach as zero-duration
    leaves)."""
    root: List[Dict[str, Any]] = []
    stack: List[tuple] = []  # (depth, node)
    for e in sorted(events, key=lambda e: (e.t0, -e.t1)):
        node: Dict[str, Any] = {
            "name": e.name,
            "t0": round(e.t0, 6),
            "seconds": round(e.seconds, 6),
        }
        if e.detail:
            node["detail"] = e.detail
        if getattr(e, "kind", "span") == "instant":
            node["instant"] = True
        node["children"] = []
        while stack and stack[-1][0] >= e.depth:
            stack.pop()
        (stack[-1][1]["children"] if stack else root).append(node)
        stack.append((e.depth, node))

    # drop empty children arrays for a compact artifact
    def _prune(nodes: List[Dict[str, Any]]) -> None:
        for n in nodes:
            if n["children"]:
                _prune(n["children"])
            else:
                del n["children"]

    _prune(root)
    return root


__all__ = ["span_tree"]
