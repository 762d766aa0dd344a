"""Reduction of a ``torch.profiler`` Chrome trace to the benchmark's
readings: the traced window, the device's busy time in it (the union of
every kernel's, copy's and set's interval), the device operations that
took most time, and the longest idle gaps by what the host was doing.

The traced window runs from the start of the first ``ROUND`` range (one
around each traced round, on the host) to the end of the last.
"""
from __future__ import annotations

import re

#: the profiler range around each traced round
ROUND = "portbench_round"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    """A trace's events, with its window and device intervals."""

    def __init__(self, events: list):
        self.events = events
        rounds = [e for e in events if e.get("cat") == "user_annotation"
                  and e.get("name") == ROUND]
        self.n_rounds = len(rounds)
        self.start = min((e["ts"] for e in rounds), default=0.0)
        self.end = max((e["ts"] + e["dur"] for e in rounds), default=0.0)
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS
                       and self.start <= e["ts"] < self.end]

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_intervals(self) -> list:
        """The union of the device intervals, clipped to the window."""
        spans = sorted((e["ts"], min(e["ts"] + e.get("dur", 0.0), self.end))
                       for e in self.device)
        out = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernels(self, pattern: str) -> list:
        """Kernel events whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return [e for e in self.device if e.get("cat") == "kernel"
                and rx.search(e.get("name", ""))]

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most
        time, summed by name."""
        by = {}
        for e in self.device:
            by[e["name"]] = by.get(e["name"], 0.0) + e.get("dur", 0.0) / 1e6
        return [[n[:160], s] for n, s in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[[host op, seconds]]: the device's idle time in the window,
        each gap named by the innermost host op running at its middle,
        summed by name, the longest first."""
        busy = self.busy_intervals()
        gaps, t = [], self.start
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end > t:
            gaps.append((t, self.end))
        gaps.sort(key=lambda g: (g[0] + g[1]) / 2)
        mids = [(a + b) / 2 for a, b in gaps]
        best = [("host: no op", float("inf"))] * len(gaps)
        threads: dict = {}
        for e in self.events:
            if e.get("cat") in ("cpu_op", "user_annotation"):
                threads.setdefault(e["tid"], []).append(
                    (e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]))
        for ops in threads.values():      # ops of one thread nest
            ops.sort(key=lambda o: (o[0], -o[1]))
            stack, i = [], 0
            for j, mid in enumerate(mids):
                while i < len(ops) and ops[i][0] <= mid:
                    while stack and stack[-1][1] < ops[i][0]:
                        stack.pop()
                    stack.append(ops[i])
                    i += 1
                while stack and stack[-1][1] < mid:
                    stack.pop()
                if stack and stack[-1][1] - stack[-1][0] < best[j][1]:
                    best[j] = (stack[-1][2], stack[-1][1] - stack[-1][0])
        by = {}
        for (a, b), (name, _) in zip(gaps, best):
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return [[n[:160], s] for n, s in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]
