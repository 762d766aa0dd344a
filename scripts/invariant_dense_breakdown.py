#!/usr/bin/env python3
"""Where invariant_dense's time goes, on one NVIDIA GPU.

    python3 scripts/invariant_dense_breakdown.py    # from the repo root

Builds timing-only copies of ``csrc/invariant_dense.cu`` into
``build/invariant_dense_breakdown/``, each with one part cut out (its
results are wrong; only its time is read): the products (``no_mma``),
the TMA loads (``no_loads``: the producer arrives on each stage without
copying), the fold of a split K (``no_fold``: the partials are written
and the cluster's barriers met, nothing summed) and everything after the
main loop of a split problem (``no_epilogue``); and one with the
deep one-block-an-SM rings turned off (``shallow``). Times each, through
the wrapper with the copy's entry swapped in, at minitron-8b's
projections and the serving path's two groups, at M 4 and M 256 with the
weights cold (``chip_smoke.cold_ms``); the whole kernel also with each
prefill form forced at M 256. Prints how many thread-block clusters of
each size every form's launch holds on the card at once
(``cudaOccupancyMaxActiveClusters``) and ``torch.matmul`` beside.
"""
import ctypes
import math
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
from repro_torch.kernels import invariant_dense as idn  # noqa: E402

#: variant -> (text of the source, its replacement)
CUTS = {
    "whole": [],
    "no_mma": [("            wgmma_ss<WN, 1>(",
                "            if (false) wgmma_ss<WN, 1>(")],
    "no_loads": [("        mbar_expect_tx(&full[s], bytes);",
                  "        mbar_arrive(&full[s]);"),
                 ("          tma_load_2d(st + j * kXTile",
                  "          if (false) tma_load_2d(st + j * kXTile"),
                 ("          tma_load_2d(st + F::kXBytes",
                  "          if (false) tma_load_2d(st + F::kXBytes")],
    "no_fold": [("  if (fold) {\n    const int base",
                 "  if (false) {\n    const int base")],
    "no_epilogue": [("  if (a.C == 1) return;", "  return;")],
    "shallow": [("blocks / a.C <= deep.capacity(a.C)", "false")],
}

#: appended to each copy: clusters of C a form's launch holds at once
CAPACITY = """
template <int CONS, int MT, int STAGES, int BPS>
int clusters(int C) {
  Launch<CONS, MT, STAGES, BPS> l(64 * C, C, nullptr);
  return l.capacity(C);
}
extern "C" int invariant_dense_clusters(int form, int deep, int C) {
  if (form == 0) return deep ? clusters<1, 1, 8, 1>(C) : clusters<1, 1, 4, 2>(C);
  if (form == 1) return deep ? clusters<2, 1, 6, 1>(C) : clusters<2, 1, 3, 2>(C);
  return clusters<2, 2, 4, 1>(C);
}
"""

#: the timed cases: one projection or a group of them
CASES = {"wq": ("wq",), "wk": ("wk",), "w_in": ("w_in",),
         "w_out": ("w_out",), "lm_head": ("lm_head",),
         "wq|wk|wv": ("wq", "wk", "wv"), "w_in|w_gate": ("w_in", "w_gate")}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    out_dir = ROOT / "build" / "invariant_dense_breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    for h in build.CSRC.glob("*.cuh"):
        shutil.copy(h, out_dir / h.name)
    base = (build.CSRC / "invariant_dense.cu").read_text()
    procs = {}
    for name, cuts in CUTS.items():
        src = base
        for old, new in cuts:
            if old not in src:
                sys.exit(f"{name}: the source no longer holds {old!r}")
            src = src.replace(old, new)
        (out_dir / f"{name}.cu").write_text(src + CAPACITY)
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
             str(out_dir / f"{name}.so"), str(out_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"nvcc failed on {name}:\n{log[-2000:]}")
        libs[name] = ctypes.CDLL(str(out_dir / f"{name}.so"))
        libs[name].invariant_dense.argtypes = list(
            build.SIGNATURES["invariant_dense"])
        libs[name].invariant_dense.restype = ctypes.c_int
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    torch.empty(1, device="cuda")                 # a context first
    caps = libs["whole"].invariant_dense_clusters
    for form, deep in ((0, 1), (0, 0), (1, 1), (1, 0), (2, 0)):
        print(f"form {form}{' deep' if deep else ''}: clusters held at "
              "once by size " + ", ".join(
                  f"{C}: {caps(form, deep, C)}" for C in (1, 2, 4, 8)))

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(27)
    names = sorted({n for c in CASES.values() for n in c})
    w = {n: (torch.randn(*cs.DENSE_PROJ[n], device=dev, generator=g)
             * cs.DENSE_PROJ[n][0] ** -0.5).to(torch.bfloat16)
         for n in names}
    x = {K: torch.randn(max(cs.DENSE_TIMED), K, device=dev,
                        generator=g).to(torch.bfloat16)
         for K in {cs.DENSE_PROJ[n][0] for n in names}}
    sets = {}
    for case, ns in CASES.items():
        nbytes = sum(w[n].numel() * 2 for n in ns)
        sets[case] = [[w[n] for n in ns]] + [
            [w[n].clone() for n in ns]
            for _ in range(max(0, math.ceil(2 * cs.L2_BYTES / nbytes) - 1))]
    own_form = idn.form

    def timed(fn, M, forced=None):
        idn.build = types.SimpleNamespace(load=lambda: types.SimpleNamespace(
            invariant_dense=fn))
        idn.form = own_form if forced is None else (
            lambda M, K, Ns, sms: 0 if M <= idn.DECODE_ROWS else forced)
        idn._plan.cache_clear()
        row = []
        for case, ns in CASES.items():
            xm = x[cs.DENSE_PROJ[ns[0]][0]][:M].contiguous()
            row.append(f"{case} {cs.cold_ms(torch, lambda wl: idn.invariant_dense_group(xm, [(t, None) for t in wl]), sets[case]):.4f}")  # noqa: E501
        return ", ".join(row)

    for M in cs.DENSE_TIMED:
        for name, lib in libs.items():
            print(f"M {M} {name}: {timed(lib.invariant_dense, M)}", flush=True)
        if M > idn.DECODE_ROWS:
            for forced in (1, 2):
                print(f"M {M} whole, form {forced} forced: "
                      f"{timed(libs['whole'].invariant_dense, M, forced)}",
                      flush=True)
        row = []
        for case, ns in CASES.items():
            xm = x[cs.DENSE_PROJ[ns[0]][0]][:M].contiguous()
            row.append(f"{case} {cs.cold_ms(torch, lambda wl: [torch.matmul(xm, t) for t in wl], sets[case]):.4f}")  # noqa: E501
        print(f"M {M} torch.matmul: {', '.join(row)}", flush=True)
    idn.form = own_form
    idn._plan.cache_clear()


if __name__ == "__main__":
    main()
