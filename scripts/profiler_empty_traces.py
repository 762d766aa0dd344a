"""How often a torch.profiler session traces no device activity when CUDA
graphs are captured between sessions, with CUPTI torn down after each
session (PyTorch's default) and with it kept (``TEARDOWN_CUPTI=0``, the
setting chip_smoke.py runs under).

    python3 scripts/profiler_empty_traces.py [--rounds 40]

Each setting runs in a process of its own. A round there times
mamba2_fwd at the pod shape with chip_smoke's ``device_ms`` (CUDA graphs
of 5 calls, replayed), then opens one profiler session around a call of
mamba2_fwd and one around a call of mamba2_bwd (chip_smoke's
``device_events`` with one try each). Prints, for each setting, the
sessions opened and those that traced no device event, as one JSON line
after the card's name and power limit. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_CHILD = """
import json, sys
sys.path[:0] = ["src", "."]
import torch
import chip_smoke as cs
from repro_torch.kernels import mamba2_scan as ms
cs.TRACE_TRIES = 1
g = torch.Generator(device=torch.device("cuda")).manual_seed(28)
B, S, H, N, decay, h0_on, _ = cs.MAMBA_MAIN
a, xdt, Bm, Cm, h0, dy, dh = cs.mamba2_inputs(torch, g, B, S, H, N, decay,
                                              h0_on)
states = ms.mamba2_fwd(a, xdt, Bm, Cm, h0)[2]
empty_rounds = []
for r in range({rounds}):
    cs.device_ms(torch, lambda: ms.mamba2_fwd(a, xdt, Bm, Cm, h0), reps=5,
                 replays=10)
    n = sum(e for _, _, e in cs.TRACE_LOG)
    cs.device_kernels(torch, lambda: ms.mamba2_fwd(a, xdt, Bm, Cm, h0),
                      "mamba2_fwd")
    cs.device_kernels(torch, lambda: ms.mamba2_bwd(dy, dh, a, xdt, Bm, Cm,
                                                   states), "mamba2_bwd")
    if sum(e for _, _, e in cs.TRACE_LOG) > n:
        empty_rounds.append(r)
print("EMPTY-TRACES " + json.dumps(dict(
    sessions=len(cs.TRACE_LOG), empty=sum(e for _, _, e in cs.TRACE_LOG),
    empty_rounds=empty_rounds)))
"""


def run(rounds: int, teardown: bool) -> dict:
    env = dict(os.environ)
    env.pop("TEARDOWN_CUPTI", None)
    if not teardown:
        env["TEARDOWN_CUPTI"] = "0"
    proc = subprocess.run([sys.executable, "-c",
                           _CHILD.format(rounds=rounds)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=1200)
    sys.stderr.write(proc.stderr[-3000:])
    if proc.returncode != 0:
        raise SystemExit(f"teardown={teardown}: exit {proc.returncode}")
    line = next(x for x in proc.stdout.splitlines()
                if x.startswith("EMPTY-TRACES "))
    return json.loads(line[len("EMPTY-TRACES "):])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=40)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    out = {f"teardown {'on' if t else 'off'}": run(args.rounds, t)
           for t in (True, False)}
    print(json.dumps(dict(rounds=args.rounds, **out)))


if __name__ == "__main__":
    main()
