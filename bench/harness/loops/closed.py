"""Loop ``closed``: one client hands the next unit of work as soon as the
last one returned, until ``seconds`` have passed since ``t0``; the window
ends with the unit that crosses the time.  Each unit's latency counts from
its own handing."""
from __future__ import annotations

import time
from typing import List

from bench.harness.trace import Span


def run(drv, seconds: float, t0: float) -> List[Span]:
    """Hand ``drv`` units in a closed loop; ``t0`` is the window's start on
    ``time.perf_counter``.  Returns the spans of every call."""
    spans: List[Span] = []
    while True:
        spans += drv.step()
        if time.perf_counter() - t0 >= seconds:
            return spans
