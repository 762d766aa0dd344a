#!/usr/bin/env python3
"""Where serve_attention's time goes, on one NVIDIA GPU.

    python3 scripts/serve_attention_breakdown.py    # from the repo root

Builds timing-only copies of ``csrc/serve_attention.cu`` into
``build/serve_attention_breakdown/``, each with one phase cut out (its
results are wrong; only its time is read): the P.V sums (``no_pv``), the
tensor-core scores (``no_mma``), the online softmax (``no_softmax``), the
fold of the spans (``no_fold``: every block writes its span as if it
were the only one), every tile (``no_tiles``: the slot table, the first
copies and the fold) and both (``no_tiles_no_fold``). Times each beside
the whole kernel at chip_smoke's SERVE_TIMED cases (CUDA-graph replay,
``chip_smoke.device_ms``) and prints one line a case.
"""
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402

#: variant -> (text of the source, its replacement)
CUTS = {
    "whole": [],
    "no_pv": [("for (int sl = 0; sl < kTile; ++sl) {\n        float v[E], pw",
               "for (int sl = 0; sl < 0; ++sl) {\n        float v[E], pw"),
              ("for (int sl = 0; sl < kTile && ls0 + sl < span_n; ++sl)",
               "for (int sl = 0; sl < 0; ++sl)")],
    "no_mma": [("for (int p = warp; p < m_frags * 4; p += kWarps)",
                "for (int p = warp; p < 0; p += kWarps)")],
    "no_softmax": [("if (ri[k] >= 0) {                    // warp-uniform",
                    "if (false) {")],
    "no_fold": [("if (a.spans == 1) {", "if (true) {")],
    "no_tiles": [("for (int tt = 0; tt < tiles; ++tt) {",
                  "for (int tt = 0; tt < 0; ++tt) {")],
}
CUTS["no_tiles_no_fold"] = CUTS["no_tiles"] + CUTS["no_fold"]


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    out_dir = ROOT / "build" / "serve_attention_breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    for h in build.CSRC.glob("*.cuh"):
        shutil.copy(h, out_dir / h.name)
    base = (build.CSRC / "serve_attention.cu").read_text()
    procs = {}
    for name, cuts in CUTS.items():
        src = base
        for old, new in cuts:
            if old not in src:
                sys.exit(f"{name}: the source no longer holds {old!r}")
            src = src.replace(old, new)
        (out_dir / f"{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
             str(out_dir / f"{name}.so"), str(out_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"nvcc failed on {name}:\n{log[-2000:]}")
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")).serve_attention
        fn.argtypes = list(build.SIGNATURES["serve_attention"])
        fn.restype = ctypes.c_int
        libs[name] = fn
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(23)
    count = torch.zeros(1 << 16, dtype=torch.int32, device=dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    null = ctypes.c_void_p(None)
    H, KH, hd, L = cs.SERVE_H, cs.SERVE_KH, cs.SERVE_HD, cs.SERVE_L
    for case in cs.SERVE_TIMED:
        dtype, B, c, window, pads, label = case
        st = cs.serve_state(torch, g, ref, dtype, B, c, window, pads)
        q, k, v, pos = st["q"], st["k"], st["v"], st["pos"]
        ck, cv, cpos = st["dense"]
        rows = c * (H // KH)
        rpw = 1 if rows <= 8 else 8
        spans = -(-L // 256)
        line = [label]
        for name, fn in libs.items():
            part = torch.empty(B, KH, rows, spans, hd + 4,
                               dtype=torch.float32, device=dev)
            out = torch.empty_like(q)

            def call(fn=fn, out=out, part=part):
                err = fn(1, hd, ptr(q), ptr(k), ptr(v), ptr(pos), ptr(ck),
                         ptr(cv), ptr(cpos), null, null, ptr(out), ptr(part),
                         ptr(count), B, c, H, KH, B, L, 1, window, rpw,
                         ctypes.c_void_p(
                             torch.cuda.current_stream().cuda_stream))
                if err:
                    sys.exit(f"{name}: CUDA error {err} at launch")
            line.append(f"{name} {cs.device_ms(torch, call, 10, 10):.4f}")
        print(" | ".join(line), flush=True)


if __name__ == "__main__":
    main()
