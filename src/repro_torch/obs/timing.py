"""Scoped wall-clock phase timers and the ``torch.profiler`` hooks.

PyTorch launches CUDA work asynchronously: an op returns as soon as the
work is enqueued, so a host clock around it measures the enqueue, not
the execution. Every timer here is ``time.perf_counter`` and closes its
span with a CUDA synchronize when the span's outputs hold CUDA tensors,
so a phase's seconds are the seconds the card spent.

``PhaseTimes`` accumulates named phases (stage / compile / scan_dispatch
/ round_dispatch / eval / checkpoint) across a run; the engine carries
one and the ``MetricsLogger`` writes its summary. "compile" is the wall
time of the first dispatch of a chunk length (in the port: the kernel
library's build and load, and cuDNN's set-up, with the first
execution); later dispatches book under their own phase.

``profile_trace`` / ``annotate`` are the ``--profile DIR`` hooks: a
``torch.profiler`` context around the run that writes a Chrome trace
into DIR, and named ``record_function`` regions around chunks, staging
and eval.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time

import torch

__all__ = ["PhaseTimes", "sync_time", "profile_trace", "annotate"]


def _cuda_devices(tree, found: set) -> set:
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, found)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, found)
    return found


def _block(tree) -> None:
    """Wait for the CUDA work behind every CUDA tensor in ``tree``."""
    for dev in _cuda_devices(tree, set()):
        torch.cuda.synchronize(dev)


def sync_time(fn, *args, **kwargs):
    """(seconds, result) of ``fn(*args, **kwargs)``, the span closed by
    a CUDA synchronize when the result holds CUDA tensors."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    _block(out)
    return time.perf_counter() - t0, out


class _Span:
    """Yielded by ``PhaseTimes.phase``; ``sync(tree)`` names the outputs
    whose completion closes the span."""

    __slots__ = ("_tree",)

    def __init__(self):
        self._tree = None

    def sync(self, tree):
        self._tree = tree
        return tree


class PhaseTimes:
    """Thread-safe accumulator of named wall-clock phases. Staging runs
    on the prefetcher's worker thread while the rounds run on the main
    thread, so phases of distinct names may overlap: the summary says
    where time was spent, not a partition of the wall."""

    def __init__(self):
        self._lock = threading.Lock()
        self.seconds: dict[str, float] = {}
        self.calls: dict[str, int] = {}

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self.seconds[name] = self.seconds.get(name, 0.0) + seconds
            self.calls[name] = self.calls.get(name, 0) + 1

    @contextlib.contextmanager
    def phase(self, name: str):
        """``with times.phase("eval") as span: span.sync(out)``: the span
        closes only after the synced outputs are ready."""
        span = _Span()
        t0 = time.perf_counter()
        try:
            yield span
        finally:
            if span._tree is not None:
                _block(span._tree)
            self.add(name, time.perf_counter() - t0)

    def summary(self) -> dict:
        """{phase: {"seconds": s, "calls": n}}, insertion-ordered."""
        with self._lock:
            return {k: {"seconds": round(self.seconds[k], 6),
                        "calls": self.calls[k]}
                    for k in self.seconds}

    def total(self) -> float:
        with self._lock:
            return sum(self.seconds.values())


@contextlib.contextmanager
def profile_trace(outdir: str | None):
    """``torch.profiler`` over the CPU and, when there is one, the CUDA
    device, for ``--profile DIR``: on exit the Chrome trace is written
    to ``DIR/trace.json``. A no-op context when ``outdir`` is falsy."""
    if not outdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(outdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(outdir, "trace.json"))


def annotate(name: str):
    """A named ``record_function`` region (a span in the profiler's
    timeline; next to free when no profiler runs)."""
    return torch.profiler.record_function(name)
