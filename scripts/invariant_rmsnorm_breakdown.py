#!/usr/bin/env python3
"""Where invariant_rmsnorm's time goes, on one NVIDIA GPU.

    python3 scripts/invariant_rmsnorm_breakdown.py    # from the repo root

Builds copies of ``csrc/invariant_rmsnorm.cu`` into
``build/invariant_rmsnorm_breakdown/`` that differ only in how many
16-byte vectors a thread may hold before a row takes more warps
(``kMaxVpt``: 1, 2, 4, 8, 16; the source's own value is one of them), so
the same row runs on 32 to 1 warps. Each copy is a whole, correct kernel
(its reduction order is its own plan's). Prints each copy's plan and
ptxas's registers and spills, and times both forms (the norm alone and
the residual add with it) through the wrapper with the copy's entries
swapped in, at the widths chip_smoke checks and M 4 and 256 (CUDA-graph
replay, ``chip_smoke.device_ms``; inputs warm in L2).
"""
import ctypes
import shutil
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import invariant_rmsnorm as irn  # noqa: E402

CAPS = (1, 2, 4, 8, 16)
CASES = (("bfloat16", 4096), ("bfloat16", 16384), ("float32", 256))
LINE = "constexpr int kMaxVpt = "


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    out_dir = ROOT / "build" / "invariant_rmsnorm_breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    for h in build.CSRC.glob("*.cuh"):
        shutil.copy(h, out_dir / h.name)
    base = (build.CSRC / "invariant_rmsnorm.cu").read_text()
    at = base.index(LINE) + len(LINE)
    own = int(base[at:base.index(";", at)])
    procs = {}
    for cap in CAPS:
        src = base[:at] + str(cap) + base[base.index(";", at):]
        (out_dir / f"cap{cap}.cu").write_text(src)
        procs[cap] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
             str(out_dir / f"cap{cap}.so"), str(out_dir / f"cap{cap}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for cap, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"nvcc failed on cap {cap}:\n{log[-2000:]}")
        lib = ctypes.CDLL(str(out_dir / f"cap{cap}.so"))
        lib.invariant_rmsnorm.argtypes = list(
            build.SIGNATURES["invariant_rmsnorm"])
        lib.invariant_rmsnorm.restype = ctypes.c_int
        lib.invariant_rmsnorm_plan.argtypes = list(
            build.VOID_SIGNATURES["invariant_rmsnorm_plan"])
        lib.invariant_rmsnorm_plan.restype = None
        libs[cap] = lib
        regs = [line for line in cs.ptxas_summary(log)
                if "<bf16" in line and ", 1, 1>" in line]
        print(f"cap {cap}{' (the source)' if cap == own else ''}: "
              + " | ".join(regs), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(28)
    real = irn.build
    try:
        for dtype, d in CASES:
            dt = getattr(torch, dtype)
            x = torch.randn(max(cs.DENSE_TIMED), d, device=dev,
                            generator=g).to(dt)
            h = torch.randn(max(cs.DENSE_TIMED), d, device=dev,
                            generator=g).to(dt)
            gain = (1 + 0.1 * torch.randn(d, device=dev, generator=g)).to(dt)
            for cap, lib in libs.items():
                irn.build = types.SimpleNamespace(load=lambda lib=lib: lib)
                warps, vpt, _ = irn.plan(d, dt)
                row = []
                for M in cs.DENSE_TIMED:
                    xm, hm = x[:M].contiguous(), h[:M].contiguous()
                    norm = cs.device_ms(torch, lambda: irn.invariant_rmsnorm(
                        xm, gain))
                    fused = cs.device_ms(torch, lambda: irn.
                                         invariant_add_rmsnorm(xm, hm, gain))
                    row.append(f"M {M}: norm {norm:.4f} add+norm "
                               f"{fused:.4f}")
                print(f"{dtype} d {d} cap {cap} ({warps} warps x {vpt} "
                      f"vectors): " + "; ".join(row), flush=True)
    finally:
        irn.build = real


if __name__ == "__main__":
    main()
