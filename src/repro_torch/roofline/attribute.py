"""Attribution: a step's op costs broken down by tag, the port of the
reference's ``roofline/attribute.py``.  The reference tags each HLO op
by its ``op_name`` metadata; the port tags each dispatched op by its
name and the innermost ``repro_torch`` functions on the Python stack
(``op_costs.OpCosts(tag=True)``), a kernel's reported work by the
kernel's name.  Tags are taken only when asked for: walking the stack
at every op slows a count.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

from .op_costs import OpCosts


def costs_by_tag(fn: Callable, *args, depth: int = 2, **kwargs
                 ) -> Tuple[Dict[str, float], Dict[str, float],
                            Dict[str, float]]:
    """Runs ``fn(*args, **kwargs)`` and returns (flops_by_tag,
    bytes_by_tag, coll_by_tag), each tag the op and ``depth`` functions."""
    with OpCosts(tag=True, tag_depth=depth) as c:
        fn(*args, **kwargs)
    return c.by_tag["flops"], c.by_tag["bytes"], c.by_tag["coll"]


def top(d: Dict[str, float], n: int = 12) -> str:
    tot = sum(d.values()) or 1.0
    lines = [f"  total {tot:.3e}"]
    for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]:
        lines.append(f"  {v:.3e} {v/tot*100:5.1f}%  {k}")
    return "\n".join(lines)
