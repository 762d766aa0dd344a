"""Phase-3 kernel checks of two checkouts on one card, in turns.

chip_smoke.py's phase 3 holds each kernel against its plain version and
times it. To compare two versions of a kernel (this checkout and another,
e.g. the parent commit unpacked with ``git archive`` into a git-ignored
directory), this script runs the named phase-3 checks of both checkouts'
own chip_smoke.py in turns, other, this, this, other, each in a process
of its own (both packages are ``repro_torch``), on the same card:

    python3 scripts/phase3_ab.py --other build/parent \\
        --checks server_mix_scatter,rwkv6 [--turns other,this,this,other] \\
        [--out ab.json]

Each run builds its checkout's kernels, prints its check's own table and
ends with one JSON line of its records; the script collects them into
one JSON list (``--out``) and prints the card's name and power limit.
The check ``rwkv6_pod`` is phase 4's rwkv6-3b run (full width, 8 layers,
ama_fes and fedavg, 3 rounds each) and ``main_cnn`` phase 4's paper-CNN
runs on ``server_adam`` and ``server_mix_delta``: their records hold
losses or paper metrics, which are deterministic, so one turn a
checkout is enough there (rounds/s are recorded too);
``server_mix_llm`` is server_mix at the two LLM paths' N; ``ama_mix``
runs its one-leaf and its many-leaf cases; ``server_adam`` and
``server_mix_delta`` run each checkout's own cases (a checkout's cases at
the same shapes are read side by side); ``invariant_dense`` each
checkout's projections (and, where its chip_smoke has them, its groups),
rows bitwise across M and the times at M 4 and 256; ``invariant_rmsnorm``
each checkout's norm checks. Three checks run THIS checkout's chip_smoke
code against the other checkout's package: ``dense_f32`` holds
``invariant_dense``'s f32 form rows bitwise and times it at the f32
shapes it served before slice 17 (``DENSE_F32_EARLIER``, M 4 and 256);
``add_norm`` times the residual
add followed by the norm (and the fused call where the package has it),
device and host, at d 4096 bf16, M 4 and 256; ``decode_step`` traces one
full-width 32-layer minitron-8b decode step and counts its device
kernels and the norm sites' launches and time (one turn a checkout is
enough there: the kernels a step launches do not vary). ``mamba2`` runs
each checkout's own ``check_mamba2`` on its pod-shape and decode cases
only (``MAMBA_MAIN``, ``MAMBA_DECODE``): both kernels against their
plain versions, then their device times; ``zamba2_pod`` phase 4's
zamba2-1.2b pod path (full width, all 38 layers, ama_fes and fedavg,
then masked with --no-scan for tokens/s over rounds 2-3). Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: check name -> the chip_smoke call that runs it and fills ``rec``
CHECKS = {
    "server_mix": "cs.check_server_mix(torch, sp, ref, rec)",
    "server_mix_llm": "(cs.check_server_mix_llm(torch, sp, ref, rec, "
                      "cs.LLM_N, 'LLM'), cs.check_server_mix_llm(torch, sp, "
                      "ref, rec, cs.RWKV_N, 'rwkv6 LLM'))",
    "server_mix_scatter": "cs.check_server_mix_scatter(torch, sp, ref, rec)",
    "server_async": "cs.check_server_async(torch, sp, ref, rec)",
    "server_adam": "cs.check_server_adam(torch, sp, ref, rec)",
    "server_mix_delta": "cs.check_server_mix_delta(torch, sp, ref, rec)",
    "ama_mix": "cs.check_ama_mix(torch, am, ref, rec)",
    "rwkv6": "cs.check_rwkv6(torch, rs, ref, rec)",
    "rwkv6_pod": "cs.pod_main_path(torch, train, 'rwkv6-3b', rs, "
                 "(sp, fa, rs), ref, tree_mod, rec)",
    "main_cnn": "cs.main_path(torch, train, sp, ref, tree_mod, [r for r in "
                "cs.MAIN_RUNS if r[2] in ('server_adam', 'server_mix_delta')"
                "], rec)",
    "invariant_dense": "cs.check_invariant_dense(torch, idn, ref, rec)",
    "invariant_rmsnorm": "cs.check_invariant_rmsnorm(torch, irn, ref, rec)",
    "add_norm": "this.add_norm_pair(torch, irn, rec)",
    "decode_step": "this.decode_step_record(torch, rec)",
    "dense_f32": "this.check_dense_wide(torch, idn, ref, rec, "
                 "this.DENSE_F32_EARLIER, 'its earlier f32 shapes')",
    "mamba2": "(setattr(cs, 'MAMBA_CASES', [cs.MAMBA_MAIN, "
              "cs.MAMBA_DECODE]), cs.check_mamba2(torch, ms, ref, rec))",
    "zamba2_pod": "cs.zamba2_pod_path(torch, train, cs.KernelSet(ms, fa), "
                  "(sp, fa, rs, ms), ref, tree_mod, rec)",
}

_RUN = """
import importlib.util, json, sys
sys.path.insert(0, "src")
import torch
import chip_smoke as cs
spec = importlib.util.spec_from_file_location("this", {this!r})
this = importlib.util.module_from_spec(spec)
spec.loader.exec_module(this)
from repro_torch.kernels import build, ref
from repro_torch.kernels import ama_mix as am
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import invariant_dense as idn
from repro_torch.kernels import invariant_rmsnorm as irn
from repro_torch.kernels import mamba2_scan as ms
from repro_torch.kernels import rwkv6_scan as rs
from repro_torch.kernels import server_plane as sp
from repro_torch.launch import train
from repro_torch.utils import tree as tree_mod
build.build(); build.load()
out = {{}}
for name, call in {checks!r}:
    rec = []
    eval(call)
    out[name] = rec
print("AB-RECORD " + json.dumps(out, default=str))
"""


def run(checkout: Path, checks) -> dict:
    code = _RUN.format(checks=checks, this=str(ROOT / "chip_smoke.py"))
    proc = subprocess.run([sys.executable, "-c", code],
                          cwd=checkout, capture_output=True, text=True,
                          timeout=1800)
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode != 0:
        raise SystemExit(f"{checkout}: exit {proc.returncode}")
    line = next(x for x in proc.stdout.splitlines()
                if x.startswith("AB-RECORD "))
    return json.loads(line[len("AB-RECORD "):])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--checks", default="server_mix_scatter,rwkv6")
    ap.add_argument("--turns", default="other,this,this,other")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    checks = [(c, CHECKS[c]) for c in args.checks.split(",")]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    results = []
    where = {"other": args.other, "this": ROOT}
    for tag in args.turns.split(","):
        checkout = where[tag]
        print(f"=== {tag}: {checkout.resolve()}", flush=True)
        results.append(dict(run=tag, card=card, **run(checkout.resolve(),
                                                     checks)))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
