"""One run of one cell: set-up, the measured window, the traced rounds,
then the check against the plain reference.

  1. Set-up builds the ``Program`` (the port's pod path, weights drawn
     on the card from the seed) and drives its first ``CHECK_ROUNDS``
     rounds through the window's own call and feed. They warm every
     shape the cell uses; the changes of the parameters after the first
     and the last of them are kept for the check (the copies they take
     are timed apart and left out of ``setup_s``).
  2. The window runs rounds, one ``run_chunk`` call each, until one ends
     ``seconds`` or more after the window opened.
  3. With ``trace``, ``TRACE_ROUNDS`` more rounds run under
     ``torch.profiler``, each inside a ``trace.ROUND`` range.
  4. ``memory_peak_bytes`` is read (the process's peak so far; the
     window's own, from an allocator peak reset as the window opens, is
     ``peak_mem_gb``), the program's state is freed, and the
     reference (``portbench/reference``) follows the check rounds from
     the same seed; ``check.py`` compares.
"""
from __future__ import annotations

import gc
import json
import math
import os
import tempfile
import time

import torch

from portbench import check, spec
from portbench import traffic as tr
from portbench.counts import round_flops
from portbench.program import Program, host_copy
from portbench.reference.model import F32, init_params
from portbench.reference.rounds import change_norms, train
from portbench.trace import ROUND, Trace

#: rounds run under the profiler in a traced run
TRACE_ROUNDS = 3
#: what JSON cannot hold, a check's value that is not finite, reads as
_HUGE = 1.7976931348623157e308


class Run:
    """What the metric readers read."""

    def __init__(self, cell):
        self.cfg, self.traffic = cell.cfg, cell.traffic
        self.tokens_per_round = tr.tokens_per_round(cell.traffic)
        self.round_flops = round_flops(cell.cfg, cell.traffic,
                                       tr.n_limited(cell.traffic))
        self.setup_s = self.window_s = 0.0
        self.round_s: list = []
        self.peak_bytes = self.setup_peak_bytes = 0
        self.trace: Trace | None = None


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_rounds(prog: Program) -> tuple[dict, float]:
    """The program's readings over its first rounds, and the seconds its
    copies and norms took."""
    book = 0.0
    t = time.perf_counter()
    start = host_copy(prog.params())
    book += time.perf_counter() - t
    out = {"loss": []}
    for r in range(check.CHECK_ROUNDS):
        out["loss"].append(prog.round(r))
        if r == 0:
            t = time.perf_counter()
            out["step1"] = change_norms(prog.params(), start)
            book += time.perf_counter() - t
    t = time.perf_counter()
    out["change"] = change_norms(prog.params(), start)
    del start
    book += time.perf_counter() - t
    return out, book


def reference_readings(cell, seed: int, device, ops=F32,
                       rounds: int = check.CHECK_ROUNDS) -> dict:
    """The reference over the check rounds of the cell's traffic."""
    inputs = [(tr.round_tokens(cell.traffic, cell.cfg["vocab_size"], seed,
                               r, device),
               tr.round_limited(cell.traffic, seed, r))
              for r in range(rounds)]
    return train(cell.cfg, cell.traffic,
                 lambda: init_params(cell.cfg,
                                     tr.weights_generator(seed, device)),
                 inputs, ops)


def traced_rounds(prog: Program, r0: int, n: int) -> Trace:
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if prog.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for k in range(n):
            with record_function(ROUND):
                prog.round(r0 + k)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events)


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        fault=None) -> tuple[dict, list]:
    """(the result line's object, the lines that end standard error)."""
    prog = Program(cell.cfg, cell.traffic, seed, device, fault)
    dev = prog.device
    run = Run(cell)
    readings, book = check_rounds(prog)
    _sync(dev)
    run.setup_s = time.perf_counter() - t0 - book
    if dev.type == "cuda":
        run.setup_peak_bytes = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    r, failed = check.CHECK_ROUNDS, 0
    w0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        loss = prog.round(r)
        b = time.perf_counter()
        run.round_s.append(b - a)
        failed += not math.isfinite(loss)
        r += 1
        if b - w0 >= seconds:
            break
    run.window_s = b - w0
    if dev.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated(dev)
    peak = max(run.peak_bytes, run.setup_peak_bytes)
    if trace:
        run.trace = traced_rounds(prog, r, TRACE_ROUNDS)
    prog.close()
    del prog
    free(dev)

    t = time.perf_counter()
    ref = reference_readings(cell, seed, dev)
    ref_s = time.perf_counter() - t
    found = check.gaps(readings, ref)
    correct, checks = check.verdict(found, cell.limits)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end
              ) if dev.type == "cuda" else ():
        kind = "layer_metrics" if trace else "end_to_end"
        value = spec.reader(kind, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": correct, "attempted": len(run.round_s),
           "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                      "kind": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu"),
                      "count": 1, "memory_peak_bytes": peak}}
    if run.trace is not None:
        out["device"]["busy_s"] = run.trace.busy_s()
        out["device"]["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.device_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["rounds"] = {"window": len(run.round_s), "window_s": run.window_s,
                     "traced": run.trace.n_rounds if run.trace else 0,
                     "setup_peak_bytes": run.setup_peak_bytes,
                     "reference_s": ref_s}
    out["checks"] = {n: {"value": c["value"] if math.isfinite(c["value"])
                         else _HUGE, "limit": c["limit"]}
                     for n, c in checks.items()}
    lines = [f"program losses {readings['loss']}, reference {ref['loss']}"]
    lines += [f"{n} {v!r} not compared (worst at {at})"
              for n, (v, at) in found.items() if n not in checks]
    lines += [f"{n} {c['value']!r} limit {c['limit']!r} (worst at "
              f"{found[n][1]})" for n, c in checks.items()]
    return out, lines
