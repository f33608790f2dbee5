"""Host-side phase timing, the analogue of the reference's MEASURE_TIME
instrumentation (snippets/read_time.c, get_elapsed_time.c; semantics in
docs/timing.md): update / solve / polish / run phase timers in ms.

Per-iteration timing is meaningless here (the whole loop is one device
dispatch); instead we time dispatch phases around block_until_ready and
report per-lane iteration counts from the solver output.
"""

from __future__ import annotations

import time


class PhaseTimer:
    """Collects named phase durations in ms (update/solve/polish/run)."""

    def __init__(self):
        self.times_ms: dict[str, float] = {}
        self._start = time.perf_counter()
        self._last = self._start

    def mark(self, phase: str):
        now = time.perf_counter()
        self.times_ms[phase] = (now - self._last) * 1e3
        self._last = now

    def finish(self):
        self.times_ms["run"] = (time.perf_counter() - self._start) * 1e3
        return self.times_ms
