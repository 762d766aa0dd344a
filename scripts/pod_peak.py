"""Peak device memory of an LLM's pod path at a chosen depth, alone in a
fresh process.

One pod run (``launch.train.pod_scale``: ama_fes, 2 cohorts x 2 local
steps x 1 x 2048 tokens, the config's remat on) of each ``ARCH:LAYERS``
at full width, with its FES tail of 2 blocks; prints the parameter count,
the peak of ``torch.cuda.max_memory_allocated``, the losses and the
seconds. chip_smoke.py runs its pod paths late in one long process,
where the caching allocator's free blocks can be too scattered for a
large allocation; this gives the figure without that history (the
depth chip_smoke can take is at most the one this admits).

    python3 scripts/pod_peak.py phi-3-vision-4.2b:32 whisper-medium:24 \
        [--rounds 2]
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.utils.tree import leaves  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("runs", nargs="+", help="ARCH:LAYERS, e.g. "
                    "phi-3-vision-4.2b:32")
    ap.add_argument("--rounds", type=int, default=2)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("pod_peak.py needs a CUDA device")
    print(torch.cuda.get_device_name(0))
    for run in a.runs:
        arch, layers = run.rsplit(":", 1)
        cfg = get_arch(arch).with_(num_layers=int(layers),
                                   fes_tail_layers=2)
        argv = ["--arch", arch, "--pod", "--cohorts", "2", "--local-steps",
                "2", "--batch", "1", "--seq", "2048", "--p-limited", "0.5",
                "--algorithm", "ama_fes", "--rounds", str(a.rounds)]
        args = train.parser().parse_args(argv)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, metrics, dt = train.pod_scale(args, train.fl_config(args),
                                             torch.device("cuda"), cfg)
        n = sum(x.numel() for x in leaves(state["params"]))
        print(f"{arch} {layers} layers: {n} params, peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, losses "
              f"{[round(float(x), 4) for x in metrics['loss']]}, {dt:.2f} s "
              f"training, {time.perf_counter() - t0:.1f} s with init",
              flush=True)
        del state


if __name__ == "__main__":
    main()
