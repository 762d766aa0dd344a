"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a`` (all
started together), and the objects are linked into one shared library
with a plain C interface, which ``ctypes`` loads. The library is built
at first use into ``build/repro_torch/`` at the repository root, under a
name keyed on a hash of the sources, headers and flags, so a fresh
checkout builds by itself and an edited source rebuilds. A missing
``nvcc`` or a failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
#: B, Sq, Skv, H, Hkv, causal, window, scale of the flash-attention
#: entries
_GEO = (ctypes.c_int,) * 7 + (ctypes.c_float,)
#: C entry -> argtypes (every pointer and the stream as c_void_p)
SIGNATURES = {
    # dtype, prev, stacked, sizes, keep, coefs, out, K, N, stream
    "server_mix": (ctypes.c_int, _P, _P, _P, _P, _P, _P, ctypes.c_int,
                   ctypes.c_longlong, _P),
    # dtype, prev, stacked, qsum, qgamma, sizes, delayed, delays, tq, hyp,
    # out, qsum_out, qgamma_out, K, Q, N, stream
    "server_async": (ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                     _P),
    # dtype, prev, stacked, m, v, sizes, keep, scalars, out, m_out, v_out,
    # K, N, stream
    "server_adam": (ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                    ctypes.c_int, ctypes.c_longlong, _P),
    # dtype, rows, prev, dstacked, rowscale, sizes, keep, coefs, out, K, N,
    # stream
    "server_mix_delta": (ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, _P,
                         _P, ctypes.c_int, ctypes.c_longlong, _P),
    # dtype, prev, vals, idx, sizes, keep, coefs, out, acc, K, kk, N,
    # stream
    "server_mix_scatter": (ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P,
                           ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_longlong, _P),
    # prev dtype, stacked dtype, leaf table (host), its bytes, alpha,
    # weights, K, stream
    "ama_mix_leaves": (ctypes.c_int, ctypes.c_int, _P, ctypes.c_longlong,
                       _P, _P, ctypes.c_int, _P),
    # dtype, hd, q, k, v, out, lse, B, Sq, Skv, H, Hkv, causal, window,
    # scale, stream
    "flash_fwd": (ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P,
                  *_GEO, _P),
    # dtype, hd, dout, q, k, v, out, lse, dq, delta, B, Sq, Skv, H, Hkv,
    # causal, window, scale, stream
    "flash_bwd_dq": (ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, _P, _P,
                     _P, *_GEO, _P),
    # dtype, hd, dout, q, k, v, lse, delta, dk, dv, B, Sq, Skv, H, Hkv,
    # causal, window, scale, stream
    "flash_bwd_dkdv": (ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, _P,
                       _P, _P, *_GEO, _P),
    # dtype, hd, q, k, v, positions, ck, cv, cpos, table, ring, out, part,
    # count, B, c, H, KH, NB, bs, mb, window, rpw, stream
    "serve_attention": (ctypes.c_int, ctypes.c_int, *(_P,) * 12,
                        *(ctypes.c_int,) * 9, _P),
    # dtype, hd, q, ck, cv, out, part, count, B, c, H, KH, L, rpw, stream
    "serve_cross_attention": (ctypes.c_int, ctypes.c_int, *(_P,) * 6,
                              *(ctypes.c_int,) * 6, _P),
    # dtype, x, M, K, P, problem table (host: w, b, y, N, S each), form,
    # stream
    "invariant_dense": (ctypes.c_int, _P, *(ctypes.c_int,) * 3, _P,
                        ctypes.c_int, _P),
    # dtype, x, h, g, s, y, M, d, eps, stream (h and s null: norm only)
    "invariant_rmsnorm": (ctypes.c_int, *(_P,) * 5, ctypes.c_int,
                          ctypes.c_int, ctypes.c_float, _P),
    # hd, ckpt, r, k, v, w, u, s0, y, s_final, states, B, S, H, stream
    "rwkv6_fwd": (ctypes.c_int, ctypes.c_int, *(_P,) * 9,
                  *(ctypes.c_int,) * 3, _P),
    # hd, ckpt, dy, ds, r, k, v, w, u, states, dr, dk, dv, dw, du, ds0,
    # scratch, B, S, H, stream
    "rwkv6_bwd": (ctypes.c_int, ctypes.c_int, *(_P,) * 15,
                  *(ctypes.c_int,) * 3, _P),
    # N, ckpt, a, x, Bm, Cm, h0, y, h_final, states, decay, B, S, H, P,
    # hg, stream
    "mamba2_fwd": (ctypes.c_int, ctypes.c_int, *(_P,) * 9,
                   *(ctypes.c_int,) * 5, _P),
    # N, ckpt, dy, dh, a, x, Bm, Cm, states, da, dx, dB, dC, dh0, dBp, dCp,
    # adj, decay, B, S, H, P, hg, stream
    "mamba2_bwd": (ctypes.c_int, ctypes.c_int, *(_P,) * 16,
                   *(ctypes.c_int,) * 5, _P),
}
#: C entries that return nothing -> argtypes
VOID_SIGNATURES = {
    # counts: 6 int64, launches per flash kernel and design
    "flash_design_counts": (_P,),
    # counts: 2 int64, server_mix launches per kernel (per element, vector)
    "server_mix_design_counts": (_P,),
    # counts: 2 int64, server_async launches per kernel (per element,
    # vector)
    "server_async_design_counts": (_P,),
    # counts: 2 int64, server_adam launches per kernel (per element,
    # vector)
    "server_adam_design_counts": (_P,),
    # counts: 2 int64, server_mix_delta launches per kernel (per element,
    # vector)
    "server_mix_delta_design_counts": (_P,),
    # dtype, d, out: 4 int32, invariant_rmsnorm's plan for rows of width d
    "invariant_rmsnorm_plan": (ctypes.c_int, ctypes.c_int, _P),
}


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
                       "the port's CUDA kernels need the CUDA toolkit")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"repro_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the sources unless this exact build exists. Returns the
    library path and the compiler's log (``-Xptxas=-v`` resource usage;
    empty when the library was already built)."""
    lib = library_path()
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp, src.stem + ".o") for src in sources()]
        procs = [subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources(), objs)]
        logs = [p.communicate()[0] for p in procs]
        log = "".join(logs)
        for src, p, out in zip(sources(), procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}) on "
                                   f"{src.name}:\n{out}")
        # link to a private name, then rename: concurrent builds never
        # load a half-written library
        so = Path(tmp, lib.name)
        cmd = [nvcc(), "-shared", "-o", str(so), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(so, lib)
    return lib, log


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    for name, argtypes in VOID_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = None
    return lib
