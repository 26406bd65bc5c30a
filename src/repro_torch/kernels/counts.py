"""Launch counts that count executions.

Each kernel wrapper keeps ``launches`` (and, where its source has
variants, ``by_variant``) as plain integers on the wrapper.  A launch
issued while the current stream captures a CUDA graph does not run
then: it runs each time the graph replays.  So :func:`count_launch`
does not add it; it goes to the tally of the enclosing
:func:`recording`, and whoever replays the graph adds that tally with
:func:`add_replays` once per replay.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Iterator, List, Optional, Tuple

import torch

Tally = List[Tuple[Callable, Optional[str]]]

_tally: Optional[Tally] = None      # the tally of the capture under way


def count_launch(wrapper: Callable, variant: Optional[str] = None) -> None:
    """Count one launch of ``wrapper``'s kernel (of ``variant``): now
    if it runs now, at each replay if a graph is being captured."""
    if torch.cuda.is_current_stream_capturing():
        if _tally is not None:
            _tally.append((wrapper, variant))
        return
    wrapper.launches += 1
    if variant is not None:
        wrapper.by_variant[variant] += 1


@contextmanager
def recording() -> Iterator[Tally]:
    """Collect the launches captured inside the ``with`` block."""
    global _tally
    outer, _tally = _tally, []
    try:
        yield _tally
    finally:
        _tally = outer


def add_replays(tally: Tally, times: int = 1) -> None:
    """Count ``times`` replays of a graph whose capture gave ``tally``."""
    for wrapper, variant in tally:
        wrapper.launches += times
        if variant is not None:
            wrapper.by_variant[variant] += times
