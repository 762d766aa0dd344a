"""Readings for a cell's limits, on the card at the cell's own size.

    python3 portbench/tools/calibrate.py --workload <cell> --seeds 12 \
        --controls 3 --faults 3 [--out FILE]

For each of ``--seeds`` seeds, in one process: the program's check
rounds (as a run's set-up drives them) and the f32 reference's, and
their gaps (``check.gaps``). On the first ``--controls`` seeds also
the control, the reference computed in float8 (``reference.model.FP8``),
against the f32 reference; on the first ``--faults`` seeds the program
with each planted fault of ``faults.py`` that needs a run (a state left
unchanged reads 1 by construction). One JSON object a reading, to
standard output and to ``--out``.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"

import torch  # noqa: E402

from portbench import check, harness, spec  # noqa: E402
from portbench.faults import AnswerAltered, HalfBatch  # noqa: E402
from portbench.program import Program  # noqa: E402
from portbench.reference.model import FP8  # noqa: E402

#: the first calibration seed (large, as the driver's are)
SEED0 = 3_000_000_019


def program_readings(cell, seed, device, fault=None):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    prog = Program(cell.cfg, cell.traffic, seed, device, fault)
    out, _ = harness.check_rounds(prog)
    prog.close()
    del prog
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    harness.free(device)
    return out, time.perf_counter() - t, peak


def calibrate(cell, seeds, controls, faults, device, emit):
    for i in range(seeds):
        seed = SEED0 + 7919 * i
        prog, prog_s, peak = program_readings(cell, seed, device)
        t = time.perf_counter()
        ref = harness.reference_readings(cell, seed, device)
        ref_s = time.perf_counter() - t
        harness.free(device)
        rows = [("program", prog, {"seconds": prog_s, "peak_bytes": peak})]
        if i < controls:
            t = time.perf_counter()
            ctl = harness.reference_readings(cell, seed, device, FP8)
            rows.append(("control_fp8", ctl,
                         {"seconds": time.perf_counter() - t}))
            harness.free(device)
        if i < faults:
            for fault in (HalfBatch(), AnswerAltered()):
                got, s, _ = program_readings(cell, seed, device, fault)
                rows.append((f"fault_{fault.name}", got, {"seconds": s}))
        for kind, got, extra in rows:
            g = check.gaps(got, ref)
            emit({"cell": cell.name, "seed": seed, "kind": kind,
                  **{k: v[0] for k, v in g.items()},
                  "worst": {k: v[1] for k, v in g.items()},
                  "loss": got["loss"], "ref_loss": ref["loss"],
                  "ref_seconds": ref_s, **extra})
        gc.collect()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("calibrate.py needs a CUDA device")
    cell = spec.load(a.workload)
    out = open(a.out, "a") if a.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    try:
        calibrate(cell, a.seeds, a.controls, a.faults, torch.device("cuda"),
                  emit)
    finally:
        if out:
            out.close()


if __name__ == "__main__":
    main()
